"""Fault manager: the share (%) of the traced window in which the card was
idle while the host was in the step's scan (the program's ``serve.scan``
span: wearout, the probe's host operands, their copy, the probe kernel, the
flags' sync).  Read as ``step_idle_share.serve`` is, and None where it is."""
from hyca_bench.metrics.step_idle_share import idle_share

SPANS = ("serve.scan",)


def read(rec, metric):
    return idle_share(rec, SPANS)
