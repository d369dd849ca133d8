"""The benchmark's frozen operation and byte counts, one module per model
family (``counts/<family>.py``), and the chip's peaks (``peaks.json``)."""
