"""Logical-axis sharding specs over a mesh's axis names and sizes."""
