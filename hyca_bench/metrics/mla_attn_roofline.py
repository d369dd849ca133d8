"""Attention: the ``counts/`` bound time of the traced block's MLA
attention cores (``mla_attn_bound_s``: the causal work at the bf16 peak, or the
query, latent and output bytes at the HBM peak, whichever is longer), over
the device time inside the program's ``attn.mla`` span
(:func:`hyca_bench.harness.marks.span_device_s`), as a share (%).  It reads
the same work whatever implements the core.  None where the span's marks
are missing or unpaired."""
from hyca_bench.harness.marks import span_device_s


def read(rec, metric):
    inside = span_device_s(rec, "attn_mla")
    cores = [c for c in rec.get("profiled_calls", ()) if c["kernel"] == "mla_attn"]
    if not inside or not cores:
        return None
    return 100.0 * sum(rec["counts"].mla_attn_bound_s(rec["model"], c["b"], c["s"]) for c in cores) / inside
