"""The port's paper model held against the JAX package: fault models,
RR/CR/DR/HyCA repair, the array timing model, the area and performance
models, the reliability loop and the paper's DLA config.

All of these are host numpy on both sides, so every output must be
identical: maps and draws bit for bit at the same seed, floats exactly (the
same arithmetic in the same order).  The reference's property tests of the
repair schemes and the fault models run on the port's functions too.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

from repro.configs import hyca_dla as j_dla
from repro.core import area as j_area
from repro.core import array_sim as j_sim
from repro.core import fault_models as j_fm
from repro.core import perf_model as j_perf
from repro.core import redundancy as j_red
from repro.core import reliability as j_rel
from repro.core.engine import _stuck_at_i32 as j_stuck_at
from repro_torch.configs import hyca_dla as t_dla
from repro_torch.core import area as t_area
from repro_torch.core import array_sim as t_sim
from repro_torch.core import fault_models as t_fm
from repro_torch.core import perf_model as t_perf
from repro_torch.core import redundancy as t_red
from repro_torch.core import reliability as t_rel


def _map(rows, cols, coords):
    m = np.zeros((rows, cols), bool)
    for r, c in coords:
        m[r, c] = True
    return m


# --------------------------------------------------------------------------- #
# fault models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 11])
def test_random_maps_identical(seed):
    a = j_fm.random_fault_maps(np.random.default_rng(seed), 50, 16, 12, 0.04)
    b = t_fm.random_fault_maps(np.random.default_rng(seed), 50, 16, 12, 0.04)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size_mean", [1.0, 4.0])
@pytest.mark.parametrize("sigma", [0.5, 1.5, 500.0])
def test_clustered_maps_identical(sigma, size_mean):
    """Same generator, same maps: the port makes the reference's numpy calls
    in the reference's order, and leaves the generator in the same state."""
    ga, gb = np.random.default_rng(5), np.random.default_rng(5)
    a = j_fm.clustered_fault_maps(ga, 60, 16, 16, 0.05, cluster_size_mean=size_mean, cluster_sigma=sigma)
    b = t_fm.clustered_fault_maps(gb, 60, 16, 16, 0.05, cluster_size_mean=size_mean, cluster_sigma=sigma)
    np.testing.assert_array_equal(a, b)
    assert ga.bit_generator.state == gb.bit_generator.state


@pytest.mark.parametrize("model", ["random", "clustered"])
def test_sample_fault_maps_identical(model):
    a = j_fm.sample_fault_maps(np.random.default_rng(3), 40, 8, 8, 0.06, model)
    b = t_fm.sample_fault_maps(np.random.default_rng(3), 40, 8, 8, 0.06, model)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown fault model"):
        t_fm.sample_fault_maps(np.random.default_rng(0), 1, 4, 4, 0.1, "nope")


def test_clustered_maps_param_validation(rng):
    with pytest.raises(ValueError, match="cluster_size_mean"):
        t_fm.clustered_fault_maps(rng, 1, 8, 8, 0.05, cluster_size_mean=0.5)
    with pytest.raises(ValueError, match="cluster_sigma"):
        t_fm.clustered_fault_maps(rng, 1, 8, 8, 0.05, cluster_sigma=-1.0)


def test_per_ber_conversions_identical():
    ber = np.geomspace(1e-9, 1e-2, 23)
    np.testing.assert_array_equal(t_fm.per_from_ber(ber), j_fm.per_from_ber(ber))
    per = t_fm.per_from_ber(ber)
    np.testing.assert_array_equal(t_fm.ber_from_per(per), j_fm.ber_from_per(per))
    assert t_fm.BITS_PER_PE == j_fm.BITS_PER_PE == 64
    np.testing.assert_array_equal(t_fm.per_from_ber(1e-3, bits_per_pe=16), j_fm.per_from_ber(1e-3, bits_per_pe=16))


@given(st.floats(min_value=0, max_value=0.1))
@settings(max_examples=30, deadline=None)
def test_per_ber_roundtrip(ber):
    per = t_fm.per_from_ber(ber)
    assert np.isclose(t_fm.ber_from_per(per), ber, rtol=1e-9, atol=1e-12)
    assert 0.0 <= per <= 1.0


@given(st.floats(min_value=0.001, max_value=0.15), st.integers(0, 2**31 - 1), st.sampled_from(["random", "clustered"]))
@settings(max_examples=15, deadline=None)
def test_maps_marginal_rate_within_binomial_ci(per, seed, model):
    """Clustered placement keeps the random model's marginal rate: each map's
    count is Binomial(R*C, per) by construction (5-sigma CI)."""
    n, rows, cols = 150, 16, 16
    maps = t_fm.sample_fault_maps(np.random.default_rng(seed), n, rows, cols, per, model)
    assert abs(maps.mean() - per) < 5 * np.sqrt(per * (1 - per) / (n * rows * cols)) + 1e-9


@given(st.floats(min_value=0.0, max_value=1e4), st.floats(min_value=1.0, max_value=64.0), st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_clustered_maps_in_bounds_at_extreme_sigma(sigma, size_mean, seed):
    """Any sigma keeps every fault in the array and each map's exact count."""
    expect = np.random.default_rng(seed).binomial(8 * 8, 0.05, size=20)
    maps = t_fm.clustered_fault_maps(np.random.default_rng(seed), 20, 8, 8, 0.05,
                                     cluster_size_mean=size_mean, cluster_sigma=sigma)
    assert maps.shape == (20, 8, 8)
    np.testing.assert_array_equal(maps.reshape(20, -1).sum(1), expect)


@pytest.mark.parametrize("bit", [0, 15, 30, 31])
@pytest.mark.parametrize("value", [0, 1])
def test_stuck_at_apply_identical(bit, value):
    """Bit 31 is the int32 sign: stuck-at-1 on it wraps to -2**31, in the
    reference's host model, the port's and the port's engine mux alike."""
    import torch

    from repro_torch.core.engine import _stuck_at_i32

    vals = np.array([0, 1, -1, 123456, -123456, 2**31 - 1, -(2**31)], np.int64)
    a = j_fm.StuckAtFault(row=0, col=0, bit=bit, value=value).apply(vals)
    b = t_fm.StuckAtFault(row=0, col=0, bit=bit, value=value).apply(vals)
    assert b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    dev = _stuck_at_i32(torch.from_numpy(vals.astype(np.int32)), torch.tensor(bit), torch.tensor(value))
    np.testing.assert_array_equal(dev.numpy(), b)
    np.testing.assert_array_equal(np.asarray(j_stuck_at(vals.astype(np.int32), np.int32(bit), np.int32(value))), b)
    if bit == 31 and value == 1:
        assert b[0] == -(2**31)


def test_sample_stuck_at_identical():
    fmap = np.random.default_rng(2).random((8, 8)) < 0.2
    a = j_fm.sample_stuck_at(np.random.default_rng(4), fmap)
    b = t_fm.sample_stuck_at(np.random.default_rng(4), fmap)
    assert [dataclasses.astuple(f) for f in a] == [dataclasses.astuple(f) for f in b]
    assert len(b) == int(fmap.sum())


# --------------------------------------------------------------------------- #
# redundancy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,cols", [(8, 8), (16, 8), (8, 16), (12, 8)])
def test_every_scheme_identical(rows, cols, rng):
    """Every scheme's (ff, surviving columns) on random maps with unhealthy
    spares and forced diagonal faults, the port's numpy vs the reference's."""
    n = 150
    pers = rng.uniform(0.0, 0.25, size=n)
    maps = rng.random((n, rows, cols)) < pers[:, None, None]
    for i in range(0, n, 3):
        maps[i, i % rows, i % cols] = True
    for scheme in t_red.SCHEMES:
        assert t_red.n_spares(scheme, rows, cols) == j_red.n_spares(scheme, rows, cols)
        if scheme == "HyCA":
            caps = rng.integers(0, cols + 2, size=n)
            for i in range(n):
                assert t_red.hyca_repair(maps[i], int(caps[i])) == j_red.hyca_repair(maps[i], int(caps[i]))
                assert t_red.hyca_remap_repair(maps[i], int(caps[i])) == j_red.hyca_remap_repair(maps[i], int(caps[i]))
            continue
        spares = rng.random((n, t_red.n_spares(scheme, rows, cols))) < 0.4
        for i in range(n):
            got = t_red.repair(scheme, maps[i], spare_faulty=spares[i])
            assert got == j_red.repair(scheme, maps[i], spare_faulty=spares[i]), (scheme, i)
            assert t_red.repair(scheme, maps[i]) == j_red.repair(scheme, maps[i])
    with pytest.raises(ValueError, match="unknown scheme"):
        t_red.repair("XR", maps[0])


def test_dr_match_square_identical(rng):
    for _ in range(50):
        m = rng.random((6, 6)) < 0.3
        rc = [(int(r), int(c)) for r, c in zip(*np.nonzero(m))]
        ok = rng.random(6) > 0.3
        assert t_red._dr_match_square(rc, 6, ok) == j_red._dr_match_square(rc, 6, ok)


@pytest.mark.parametrize("cfg", [dict(size=32), dict(size=24, group_size=8), dict(size=16, group_size=4, mult_red_group=2)])
@pytest.mark.parametrize("per", [0.0, 0.02, 0.2])
def test_dppu_capacity_identical(cfg, per):
    a = j_red.dppu_capacity(np.random.default_rng(7), j_red.DPPUConfig(**cfg), per, 500)
    b = t_red.dppu_capacity(np.random.default_rng(7), t_red.DPPUConfig(**cfg), per, 500)
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.int64


def test_effective_capacity_identical():
    for size in (8, 16, 24, 32, 40, 48):
        for unified in (False, True):
            for col in (16, 32, 64):
                a = j_red.effective_capacity(j_red.DPPUConfig(size=size, unified=unified), col)
                b = t_red.effective_capacity(t_red.DPPUConfig(size=size, unified=unified), col)
                assert a == b


coords = st.lists(st.tuples(st.integers(0, 7), st.integers(0, 7)), min_size=0, max_size=20)


@given(coords, st.integers(0, 12))
@settings(max_examples=100, deadline=None)
def test_hyca_ff_iff_count_le_capacity(cs, cap):
    m = _map(8, 8, cs)
    ff, surv = t_red.hyca_repair(m, cap)
    assert ff == (int(m.sum()) <= cap)
    assert 0 <= surv <= 8 and (surv == 8 or not ff)


@given(coords)
@settings(max_examples=100, deadline=None)
def test_hyca_dominates_classical(cs):
    m = _map(8, 8, cs)
    _, surv_h = t_red.hyca_repair(m, 8)
    for scheme in ("RR", "CR", "DR"):
        _, surv_s = t_red.repair(scheme, m)
        assert surv_h >= surv_s


@given(coords, st.tuples(st.integers(0, 7), st.integers(0, 7)))
@settings(max_examples=100, deadline=None)
def test_adding_fault_never_helps(cs, extra):
    m = _map(8, 8, cs)
    m2 = m.copy()
    m2[extra] = True
    for scheme in ("RR", "CR", "HyCA"):
        assert t_red.repair(scheme, m2)[1] <= t_red.repair(scheme, m)[1]


@given(coords)
@settings(max_examples=100, deadline=None)
def test_dr_matching_is_maximal(cs):
    m = _map(8, 8, cs)
    ff, _ = t_red.dr_repair(m, np.zeros(8, bool))
    rs, cols_ = np.nonzero(m)
    if len(set(rs)) == int(m.sum()) and len(set(cols_)) == int(m.sum()):
        assert ff


# --------------------------------------------------------------------------- #
# array timing model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,cols,size,group", [(32, 32, 32, 8), (16, 64, 16, 4), (128, 128, 128, 8)])
def test_array_sim_identical(rows, cols, size, group):
    tc = t_sim.ArrayConfig(rows, cols, size, group)
    jc = j_sim.ArrayConfig(rows, cols, size, group)
    assert tc.delay == jc.delay
    assert t_sim.register_file_bytes(tc) == j_sim.register_file_bytes(jc)
    assert t_sim.register_file_bytes(tc, 4) == j_sim.register_file_bytes(jc, 4)
    for n_faults in (0, 1, 3, 4, 5, size, size + 1, 2 * size):
        assert t_sim.dppu_recompute_cycles(tc, n_faults) == j_sim.dppu_recompute_cycles(jc, n_faults)
        assert t_sim.recompute_keeps_up(tc, n_faults) == j_sim.recompute_keeps_up(jc, n_faults)
        for c_in, k in ((32, 1), (256, 3), (3, 11)):
            tl = t_sim.ConvLayer(c_in, k, 1024, 64)
            a = t_sim.iteration_timeline(tc, tl, n_faults)
            b = j_sim.iteration_timeline(jc, j_sim.ConvLayer(c_in, k, 1024, 64), n_faults)
            assert dataclasses.astuple(a) == dataclasses.astuple(b) and a.conflict_free == b.conflict_free
    for layer in ((3, 11, 55 * 55, 96), (4096, 1, 1, 4096), (64, 3, 56 * 56, 64)):
        assert t_sim.layer_cycles(t_sim.ConvLayer(*layer), rows, cols) == j_sim.layer_cycles(j_sim.ConvLayer(*layer), rows, cols)


def test_paper_register_file_sizes():
    """Section V-A1: WRF = IRF = 2·32·32 = 2 KB; ORF = 64 B; FPT = 32×10 bits."""
    rf = t_sim.register_file_bytes(t_sim.ArrayConfig(32, 32, 32, 8))
    assert (rf["WRF"], rf["IRF"], rf["ORF"], rf["FPT_bits"]) == (2048, 2048, 64, 320)


# --------------------------------------------------------------------------- #
# area and performance models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,cols", [(32, 32), (16, 64), (128, 128)])
def test_area_identical(rows, cols):
    a = [dataclasses.astuple(x) + (x.total, x.redundancy_overhead) for x in j_area.all_areas(rows, cols)]
    b = [dataclasses.astuple(x) + (x.total, x.redundancy_overhead) for x in t_area.all_areas(rows, cols)]
    assert a == b
    for size in (8, 48):
        ja = j_area.area_hyca(rows, cols, j_red.DPPUConfig(size=size, group_size=8))
        ta = t_area.area_hyca(rows, cols, t_red.DPPUConfig(size=size, group_size=8))
        assert dataclasses.astuple(ja) == dataclasses.astuple(ta)
    names = ("A_MULT8", "A_ADDER32", "A_PE_REGS", "A_PE_CTRL", "A_PE", "A_MUX_PER_BIT",
             "A_RF_PER_BIT", "A_SRAM_PER_KB", "BUFFERS_KB")
    assert [getattr(t_area, k) for k in names] == [getattr(j_area, k) for k in names]


def test_perf_model_identical():
    assert list(t_perf.NETWORKS) == list(j_perf.NETWORKS)
    for net in t_perf.NETWORKS:
        assert [dataclasses.astuple(l) for l in t_perf.NETWORKS[net]] == [dataclasses.astuple(l) for l in j_perf.NETWORKS[net]]
        for rows, cols in ((32, 32), (32, 7), (128, 128), (32, 0)):
            assert t_perf.network_cycles(net, rows, cols) == j_perf.network_cycles(net, rows, cols)
            assert t_perf.network_throughput(net, rows, cols) == j_perf.network_throughput(net, rows, cols)


@pytest.mark.parametrize("scheme", ["RR", "CR", "DR", "HyCA"])
@pytest.mark.parametrize("model", ["random", "clustered"])
def test_scheme_throughput_identical(scheme, model):
    kw = dict(rows=16, cols=16, fault_model=model, n_configs=60, seed=2)
    a = j_perf.scheme_throughput(scheme, "resnet18", 0.03, dppu=j_red.DPPUConfig(size=16), **kw)
    b = t_perf.scheme_throughput(scheme, "resnet18", 0.03, dppu=t_red.DPPUConfig(size=16), **kw)
    assert a == b


# --------------------------------------------------------------------------- #
# reliability loop and the paper's DLA config
# --------------------------------------------------------------------------- #
def test_point_seed_and_per_grid_golden():
    assert [t_rel.point_seed(0, i) for i in range(4)] == [7919, 15838, 23757, 31676]
    assert t_rel.point_seed(5, 0) == 5 + 7919
    assert t_rel.PER_GRID == j_rel.PER_GRID and len(t_rel.PER_GRID) == 9


@pytest.mark.parametrize("model", ["random", "clustered"])
def test_sweep_identical(model):
    kw = dict(rows=12, cols=8, fault_model=model, n_configs=80, seed=4)
    a = j_rel.sweep(("RR", "CR", "DR", "HyCA"), (0.01, 0.05), dppu=j_red.DPPUConfig(size=8, group_size=4), **kw)
    b = t_rel.sweep(("RR", "CR", "DR", "HyCA"), (0.01, 0.05), dppu=t_red.DPPUConfig(size=8, group_size=4), **kw)
    assert [dataclasses.astuple(r) for r in a] == [dataclasses.astuple(r) for r in b]


def test_hyca_dla_config_identical():
    assert t_dla.ARCH_ID == j_dla.ARCH_ID == "hyca-dla"
    assert t_dla.BUFFERS == j_dla.BUFFERS
    for size in (24, 32, 40):
        tc, jc = t_dla.dla_config(dppu_size=size), j_dla.dla_config(dppu_size=size)
        assert (tc.rows, tc.cols, tc.mode, tc.capacity) == (jc.rows, jc.cols, jc.mode, jc.capacity)
        assert dataclasses.astuple(tc.dppu) == dataclasses.astuple(jc.dppu)
        assert dataclasses.astuple(t_dla.array_config(dppu_size=size)) == dataclasses.astuple(j_dla.array_config(dppu_size=size))
    from repro_torch.configs import ARCH_IDS

    assert t_dla.ARCH_ID not in ARCH_IDS  # the array's config, not a model's
