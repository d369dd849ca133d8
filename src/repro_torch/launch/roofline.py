"""Roofline: three-term analysis per (arch × shape) on one H100.

    compute term    = FLOPs / PEAK_FLOPS_BF16                     [s]
    memory term     = bytes / HBM_BW                              [s]
    collective term = collective wire bytes / NVLINK_BW           [s]

All three use per-device quantities from the cost probes
(:mod:`repro_torch.launch.probes`; FLOPs and bytes are counts of the
port's eager step on ``meta`` tensors, the bytes unfused) or from a dry-run
record (:mod:`repro_torch.launch.dryrun`: on the production meshes one
device's FLOPs, bytes and collective wire bytes), and the card's constants
(:mod:`repro_torch.launch.hw`).  The device count is the record's mesh (1
on the host mesh).  MODEL_FLOPS is the analytic ideal
(6·N_active·D dense-train convention + exact attention terms); MODEL/HLO
shows remat and redundancy waste, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--probes-dir ...]

Writes ``experiments/bench_torch/roofline.json`` and prints the markdown table.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.launch.hw import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.lm import LMConfig

PROBES_DIR = "experiments/bench_torch/probes"
OUT = "experiments/bench_torch/roofline.json"


def _attn_flops_fwd(cfg: LMConfig, tokens: int, seq: int, causal: bool = True) -> float:
    """Score+AV matmul FLOPs for full attention over ``seq`` per token batch."""
    if cfg.family == "ssm":
        return 0.0  # linear mixer; its state ops are counted separately
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    if cfg.attn_kind == "mla":
        qk = cfg.mla.d_nope + cfg.mla.d_rope
        per_tok = 2 * cfg.n_heads * (qk + cfg.mla.d_v) * seq
    else:
        per_tok = 2 * cfg.n_heads * 2 * hd * seq
    f = per_tok * tokens
    if causal:
        f *= 0.5
    # attention applications: every layer for transformers, only the shared
    # blocks for the hybrid arch, none for pure SSMs
    n_apps = len(_hybrid_apps(cfg)) if cfg.family == "hybrid" else cfg.n_layers
    if cfg.family == "encdec":
        n_apps = cfg.n_layers + cfg.n_enc_layers  # + cross-attn ~ self-attn cost
    return f * n_apps


def _hybrid_apps(cfg: LMConfig):
    ae = cfg.attn_every or cfg.n_layers
    return list(range(0, cfg.n_layers, ae))


def model_flops(cfg: LMConfig, cell: ShapeCell) -> float:
    """Analytic ideal FLOPs per step (global), 6ND convention for train."""
    n_active = cfg.n_active_params()
    if cell.kind == "train":
        d_tokens = cell.global_batch * cell.seq_len
        lin = 6.0 * n_active * d_tokens
        attn = 3.0 * _attn_flops_fwd(cfg, d_tokens, cell.seq_len)
        return lin + attn
    if cell.kind == "prefill":
        d_tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * d_tokens + _attn_flops_fwd(cfg, d_tokens, cell.seq_len)
    # decode: one token against a seq-long cache
    d_tokens = cell.global_batch
    return 2.0 * n_active * d_tokens + _attn_flops_fwd(cfg, d_tokens, cell.seq_len, causal=False)


def _advice(dominant: str, rec: dict, cfg: LMConfig, cell: ShapeCell) -> str:
    if dominant == "compute":
        return ("compute-bound: cut recompute and redundant FLOPs (remat policy, fused loss head) "
                "or it is already near the card's ceiling")
    if dominant == "memory":
        if cell.kind == "decode":
            return ("HBM-bound on weight+KV reads: a larger decode batch amortises weight "
                    "reads; a quantised KV or MLA-style latent cache shrinks cache traffic")
        return ("HBM-bound: raise arithmetic intensity — bigger microbatch, fused "
                "attention (no score materialisation), fused elementwise chains")
    return ("NVLink-bound: re-shard to cut per-layer collectives (sequence-parallel "
            "norms, 1-hot expert dispatch), overlap the gradient all-reduce with the backward, "
            "compress data-parallel gradients")


def analyse_record(rec: dict, cfg: LMConfig | None = None, cell: ShapeCell | None = None) -> dict:
    """One probe or dry-run record's roofline row.  ``cfg`` and ``cell``
    default to the record's ``arch`` and ``shape``; pass them for a cell
    outside :data:`~repro_torch.configs.shapes.SHAPES` (a served step's).
    A dry-run record's ``cost_analysis`` and ``collectives`` are one
    device's: its ``total_wire_bytes`` is the collective term, over
    ``NVLINK_BW``, as the reference reads its compiled record's over its
    interconnect."""
    if rec.get("status") != "ok":
        return rec
    arch, shape = rec["arch"], rec["shape"]
    cfg = get_config(arch) if cfg is None else cfg
    cell = SHAPES[shape] if cell is None else cell
    n_dev = int(rec.get("n_devices", 1))
    if "total" in rec:
        t = rec["total"]
    else:
        t = {"flops": rec["cost_analysis"]["flops"], "bytes": rec["cost_analysis"]["bytes accessed"],
             "wire_bytes": rec["collectives"]["total_wire_bytes"]}
    terms = {
        "compute": max(t["flops"], 0.0) / PEAK_FLOPS_BF16,
        "memory": max(t["bytes"], 0.0) / HBM_BW,
        "collective": max(t["wire_bytes"], 0.0) / NVLINK_BW,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(cfg, cell)
    mf_dev = mf / n_dev
    ideal = mf_dev / PEAK_FLOPS_BF16
    return {
        "arch": arch, "shape": shape, "status": "ok", "n_devices": n_dev,
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": terms["collective"], "dominant": dominant,
        "bound_s": bound,
        "model_flops_global": mf,
        "model_flops_per_dev": mf_dev,
        "hlo_flops_per_dev": t["flops"],
        "model_over_hlo": mf_dev / t["flops"] if t["flops"] else 0.0,
        "roofline_fraction": ideal / bound if bound else 0.0,
        "advice": _advice(dominant, rec, cfg, cell),
    }


def analyse(probes_dir: str) -> list[dict]:
    return [analyse_record(json.load(open(path)))
            for path in sorted(glob.glob(os.path.join(probes_dir, "*.json")))]


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute (ms) | memory (ms) | collective (ms) | dominant | "
           "MODEL/HLO | roofline frac |\n|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"| {r.get('arch','?')} | {r.get('shape','?')} | FAILED | | | | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']*1e3:.2f} | "
            f"{r['memory_s']*1e3:.2f} | {r['collective_s']*1e3:.2f} | "
            f"**{r['dominant']}** | {r['model_over_hlo']:.2f} | {r['roofline_fraction']:.1%} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="three-term roofline of the probe records on one H100")
    ap.add_argument("--probes-dir", default=PROBES_DIR)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    rows = analyse(args.probes_dir)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(to_markdown(rows))
    ok = [r for r in rows if r.get("status") == "ok"]
    if ok:
        worst = min(ok, key=lambda r: r["roofline_fraction"])
        coll = max(ok, key=lambda r: r["collective_s"] / max(r["bound_s"], 1e-12))
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} "
              f"({worst['roofline_fraction']:.1%})")
        print(f"most collective-bound:   {coll['arch']}/{coll['shape']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
