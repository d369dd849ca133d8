"""repro_torch.transient — the transient fault stack (third fault class).

The permanent PE faults of the engine are detected by the ScanEngine's
probes and repaired by the DPPU.  This package adds the faults that do not
sit still:

  * :mod:`repro_torch.transient.seu`      — campaign-sampled SEU bit-flip
    injection for weight leaves, activation panels and KV-cache pages;
  * :mod:`repro_torch.transient.abft`     — syndrome checks for the
    checksum-augmented matmul (:func:`repro_torch.core.engine.abft_checksums`),
    the third detector beside the ScanEngine and the OnlineVerifier;
  * :mod:`repro_torch.transient.coverage` — the detector-coverage campaign
    (fault class × detector matrix);
  * :mod:`repro_torch.transient.memory`   — the checkpoint memory-fault
    path: tamper a stored leaf, detect it by its digest, re-fetch or refuse.
"""
from repro_torch.transient.abft import abft_check
from repro_torch.transient.coverage import CoverageSpec, run_coverage
from repro_torch.transient.memory import guarded_restore, tamper_checkpoint, tamper_leaf
from repro_torch.transient.seu import (
    FlipPlan,
    FlipSchedule,
    emit_flip_events,
    flip_bits,
    sample_flip_plans,
    sample_kv_flips,
)

__all__ = [
    "abft_check",
    "CoverageSpec",
    "run_coverage",
    "guarded_restore",
    "tamper_checkpoint",
    "tamper_leaf",
    "FlipPlan",
    "FlipSchedule",
    "emit_flip_events",
    "flip_bits",
    "sample_flip_plans",
    "sample_kv_flips",
]
