"""Seconds from the process's start to the window's first timed request:
interpreter, imports, the card, the weights, the build, the fault map's
BIST and the warm-up (with the kernels' compile on a checkout's first run)."""


def read(rec, metric):
    return rec["setup_s"]
