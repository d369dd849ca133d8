"""The system under test: the port's objects built from a configuration
file and the inputs the benchmark drew.  With the families' bridges
(``bridges/<family>.py``), this is the one harness module that imports the
port (``repro_torch``)."""
from __future__ import annotations

import torch

from hyca_bench.harness import spec
from hyca_bench.harness.inputs import draw_all, fault_map, sub_seed


def server_config(cfg: dict, seed: int, device: torch.device, n_slots: int, smax: int):
    from repro_torch.serving import ServerConfig

    s = cfg["server"]
    return ServerConfig(
        arch=cfg["arch"], n_slots=n_slots, smax=smax, mode=s["mode"], rows=s["rows"], cols=s["cols"],
        dppu_size=s["dppu_size"], protect_fraction=s["protect_fraction"], dispatch=s["dispatch"],
        scan_block=s["scan_block"], confirm_hits=s["confirm_hits"], bist=s["bist"],
        seed=sub_seed(seed, "server") % 2**31, device=str(device),
    )


def build_server(cfg: dict, seed: int, device: torch.device, n_slots: int, smax: int):
    """The protected server of ``cfg`` over weights drawn from ``seed``,
    with the seed's fault map injected before it starts (its BIST confirms
    the map at boot).  Raises unless every fault is confirmed and repaired:
    the guarantee the configuration states.  Returns (server, faults)."""
    from repro_torch.serving import FaultInjector, FaultTolerantServer, ModelBundle

    m = cfg["model"]
    bridge = spec.module("bridges", cfg["family"])
    scfg = server_config(cfg, seed, device, n_slots, smax)
    bundle = ModelBundle(scfg, lm=bridge.lm_config(cfg),
                         params=bridge.program_params(m, draw_all(bridge, m, seed, device)))
    faults = fault_map(seed, scfg.rows, scfg.cols, cfg["faults"]["n_faulty_pes"])
    injector = FaultInjector(scfg.rows, scfg.cols, seed=sub_seed(seed, "injector") % 2**31)
    for r, c, bit, val in faults:
        injector.inject_at(r, c, bit=bit, val=val)
    server = FaultTolerantServer(scfg, bundle=bundle, injector=injector)
    mgr = server.manager
    repaired = len(mgr.repaired_coords())
    if mgr.n_confirmed != len(faults) or repaired != len(faults):
        raise RuntimeError(f"{len(faults)} faults injected, {mgr.n_confirmed} confirmed, {repaired} repaired")
    return server, faults


def unrepaired_faults(server) -> int:
    """Faults of the array that the protected step still feeds its kernels:
    0 when every fault is DPPU-repaired."""
    return int((server._current_fstate().fpt[:, 0] >= 0).sum())


def prefill_step(server):
    """``launch/serve.py::make_prefill`` over the server's bundle, with the
    bundle's context holding the protected fault view of ``server``."""
    from repro_torch.launch.serve import make_prefill

    bundle = server.bundle
    bundle.ftc.swap(state=server._current_fstate(), plan=server.plan)
    prefill, _ = make_prefill(bundle.lm, str(bundle.device), ftc=bundle.ftc)
    return prefill
