"""Model stack: layers, attention and the LM composer."""
