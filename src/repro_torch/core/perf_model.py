"""Scale-sim-like analytical performance model (paper Figs. 12, 13, Table I).

Scale-sim (Samajdar et al.) is a cycle-level python model of systolic dataflows; for the
output-stationary dataflow the steady-state cycle count is closed-form
(``array_sim.layer_cycles``), which we use directly so 10k-config Monte-Carlo
sweeps stay tractable.  Networks are the paper's benchmark set — AlexNet,
VGG16, ResNet18, YOLOv2 — with layer tables from the original papers.

Degraded arrays keep all rows and the surviving column prefix (column-granular
discard, Section IV-B); throughput of a dead array (0 columns) is 0.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import fault_models as fm
from repro_torch.core import redundancy as red
from repro_torch.core.array_sim import ConvLayer, layer_cycles
from repro_torch.core.redundancy import n_spares

C = ConvLayer

# --------------------------------------------------------------------------- #
# benchmark layer tables (c_in, k, out_pixels, c_out)
# --------------------------------------------------------------------------- #
ALEXNET = [
    C(3, 11, 55 * 55, 96),
    C(96, 5, 27 * 27, 256),
    C(256, 3, 13 * 13, 384),
    C(384, 3, 13 * 13, 384),
    C(384, 3, 13 * 13, 256),
    C(9216, 1, 1, 4096),
    C(4096, 1, 1, 4096),
    C(4096, 1, 1, 1000),
]

VGG16 = (
    [C(3, 3, 224 * 224, 64), C(64, 3, 224 * 224, 64)]
    + [C(64, 3, 112 * 112, 128), C(128, 3, 112 * 112, 128)]
    + [C(128, 3, 56 * 56, 256)] + [C(256, 3, 56 * 56, 256)] * 2
    + [C(256, 3, 28 * 28, 512)] + [C(512, 3, 28 * 28, 512)] * 2
    + [C(512, 3, 14 * 14, 512)] * 3
    + [C(25088, 1, 1, 4096), C(4096, 1, 1, 4096), C(4096, 1, 1, 1000)]
)

RESNET18 = (
    [C(3, 7, 112 * 112, 64)]
    + [C(64, 3, 56 * 56, 64)] * 4
    + [C(64, 3, 28 * 28, 128), C(128, 3, 28 * 28, 128), C(64, 1, 28 * 28, 128),
       C(128, 3, 28 * 28, 128), C(128, 3, 28 * 28, 128)]
    + [C(128, 3, 14 * 14, 256), C(256, 3, 14 * 14, 256), C(128, 1, 14 * 14, 256),
       C(256, 3, 14 * 14, 256), C(256, 3, 14 * 14, 256)]
    + [C(256, 3, 7 * 7, 512), C(512, 3, 7 * 7, 512), C(256, 1, 7 * 7, 512),
       C(512, 3, 7 * 7, 512), C(512, 3, 7 * 7, 512)]
    + [C(512, 1, 1, 1000)]
)

YOLOV2 = [
    C(3, 3, 416 * 416, 32),
    C(32, 3, 208 * 208, 64),
    C(64, 3, 104 * 104, 128),
    C(128, 1, 104 * 104, 64),
    C(64, 3, 104 * 104, 128),
    C(128, 3, 52 * 52, 256),
    C(256, 1, 52 * 52, 128),
    C(128, 3, 52 * 52, 256),
    C(256, 3, 26 * 26, 512),
    C(512, 1, 26 * 26, 256),
    C(256, 3, 26 * 26, 512),
    C(512, 1, 26 * 26, 256),
    C(256, 3, 26 * 26, 512),
    C(512, 3, 13 * 13, 1024),
    C(1024, 1, 13 * 13, 512),
    C(512, 3, 13 * 13, 1024),
    C(1024, 1, 13 * 13, 512),
    C(512, 3, 13 * 13, 1024),
    C(1024, 3, 13 * 13, 1024),
    C(1024, 3, 13 * 13, 1024),
    C(1280, 3, 13 * 13, 1024),
    C(1024, 1, 13 * 13, 425),
]

NETWORKS = {
    "alexnet": ALEXNET,
    "vgg16": VGG16,
    "resnet18": RESNET18,
    "yolov2": YOLOV2,
}


def network_cycles(net: str | list[ConvLayer], rows: int, cols: int) -> int:
    layers = NETWORKS[net] if isinstance(net, str) else net
    if cols <= 0 or rows <= 0:
        return 0  # dead array — callers treat throughput as 0
    return sum(layer_cycles(l, rows, cols) for l in layers)


def network_throughput(net: str | list[ConvLayer], rows: int, cols: int) -> float:
    cyc = network_cycles(net, rows, cols)
    return 0.0 if cyc == 0 else 1.0 / cyc


# --------------------------------------------------------------------------- #
# Monte-Carlo degraded performance per redundancy scheme (Figs. 12)
# --------------------------------------------------------------------------- #
def scheme_throughput(
    scheme: str,
    net: str,
    per: float,
    *,
    rows: int = 32,
    cols: int = 32,
    fault_model: str = "random",
    n_configs: int = 1000,
    dppu: red.DPPUConfig | None = None,
    seed: int = 0,
) -> float:
    """E[throughput] over fault configs; unique surviving-column counts are
    simulated once and weighted (the paper's Scale-sim de-duplication trick)."""
    rng = np.random.default_rng(seed)
    maps = fm.sample_fault_maps(rng, n_configs, rows, cols, per, fault_model)  # type: ignore[arg-type]
    surv = np.zeros(n_configs, dtype=np.int64)
    if scheme == "HyCA":
        cfg = dppu or red.DPPUConfig(size=cols)
        caps = np.minimum(
            red.dppu_capacity(rng, cfg, per, n_configs), red.effective_capacity(cfg, cols)
        )
        for i in range(n_configs):
            _, surv[i] = red.hyca_repair(maps[i], int(caps[i]))
    else:
        spare_faults = rng.random((n_configs, n_spares(scheme, rows, cols))) < per
        for i in range(n_configs):
            _, surv[i] = red.repair(scheme, maps[i], spare_faulty=spare_faults[i])
    # de-dup: throughput depends only on the surviving column count
    uniq, counts = np.unique(surv, return_counts=True)
    tp = np.array([network_throughput(net, rows, int(c)) for c in uniq])
    return float((tp * counts).sum() / n_configs)
