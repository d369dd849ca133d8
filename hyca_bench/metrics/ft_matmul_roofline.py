"""Kernels: the ``counts/`` bound time of the traced block's ``ft_matmul``
calls over their device time, as a share (%)
(:func:`hyca_bench.harness.trace.roofline_share`)."""
from hyca_bench.harness.trace import roofline_share


def read(rec, metric):
    return roofline_share(rec, "ft_matmul")
