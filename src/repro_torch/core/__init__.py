"""Fault model, FTContext dispatch and the DPPU scan pipeline."""
