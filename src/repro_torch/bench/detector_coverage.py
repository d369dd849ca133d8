"""Detector-coverage matrix: fault class × detector, with build evidence
(the twin of the reference's detector_coverage benchmark).

The headline of the transient-fault stack: ABFT checksums catch the
transient MAC and weight-memory bit flips the ScanEngine probe structurally
cannot:

  * ``scan`` sees a MAC transient only if the cursor happened to be probing
    that row block at upset time (coverage ≈ scan_block/rows) and never
    sees a weight flip (probes supply their own operands);
  * ``verify`` (output-block recompute) re-reads the stored, corrupted
    weights, so weight flips are invisible to it too;
  * ``abft``'s carried column checksum flags MAC corruption anywhere in the
    array every step, and the encode-time weight checksum is the only
    detector of the weight-memory class.

The campaign (:func:`repro_torch.transient.coverage.run_coverage`) builds
each fault class's batched program once and runs it again on a fresh config
draw.  The claims gate the coverage separations and that the second draw
built nothing: ``retraces`` counts the port's builds a class in this call
(JAX's own retraces are a per-process jit cache and cannot be compared).
"""
from __future__ import annotations

from repro_torch.bench.common import Claims, device_name
from repro_torch.transient.coverage import CoverageSpec, run_coverage


def run(quick: bool = False, device="cuda") -> dict:
    spec = CoverageSpec(n_configs=64 if quick else 256, seed=7)
    rep = run_coverage(spec, device=device)
    cov = {(r["fault_class"], r["detector"]): r["coverage"] for r in rep["matrix"]}
    claims = Claims("detector_coverage")
    claims.check(
        "scan catches permanent stuck-ats (the PR-1..6 contract holds)",
        cov[("permanent", "scan")] >= 0.9,
        f"scan/permanent = {cov[('permanent', 'scan')]:.3f}",
    )
    claims.check(
        "scan is structurally blind to weight-memory flips",
        cov[("transient_weight", "scan")] == 0.0,
        f"scan/transient_weight = {cov[('transient_weight', 'scan')]:.3f}",
    )
    claims.check(
        "verify is structurally blind to weight-memory flips "
        "(recomputes from the same stored weights)",
        cov[("transient_weight", "verify")] == 0.0,
        f"verify/transient_weight = {cov[('transient_weight', 'verify')]:.3f}",
    )
    claims.check(
        "ABFT encode-time checksum catches weight flips nothing else sees",
        cov[("transient_weight", "abft")] >= 0.5
        and cov[("transient_weight", "abft")] >= cov[("transient_weight", "scan")] + 0.3,
        f"abft/transient_weight = {cov[('transient_weight', 'abft')]:.3f}",
    )
    claims.check(
        "ABFT beats the scan cursor on MAC transients (whole-array, every step)",
        cov[("transient_mac", "abft")] >= cov[("transient_mac", "scan")] + 0.2,
        f"abft {cov[('transient_mac', 'abft')]:.3f} vs "
        f"scan {cov[('transient_mac', 'scan')]:.3f}",
    )
    claims.check(
        "swapping fault configs through each class program retraces nothing",
        all(n == 1 for n in rep["retraces"].values()),
        f"traces per class: {rep['retraces']}",
    )
    return {
        "device": device_name(device),
        "spec": {
            "rows": spec.rows, "cols": spec.cols,
            "m": spec.m, "k": spec.k, "n": spec.n,
            "n_configs": spec.n_configs, "scan_block": spec.scan_block,
            "verify_rows": spec.verify_rows, "seed": spec.seed,
        },
        "matrix": rep["matrix"],
        "retraces": rep["retraces"],
        "claims": claims.items,
        "all_ok": claims.all_ok,
    }
