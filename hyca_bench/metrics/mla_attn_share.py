"""Attention: the share (%) of the traced block's device busy time spent in
MLA's attention core, the program's ``attn.mla`` span (scores, mask,
softmax, the weighted sum and their casts, from the expanded keys and
values to the heads' output), between the span's device marks
(:func:`hyca_bench.harness.marks.span_device_s`).  None where the program
launches no marks (the parent; ``--trace 0``) or the trace lost one."""
from hyca_bench.harness.marks import span_device_s


def read(rec, metric):
    inside = span_device_s(rec, "attn_mla")
    if inside is None:
        return None
    return 100.0 * inside / rec["profile"]["busy_s"]
