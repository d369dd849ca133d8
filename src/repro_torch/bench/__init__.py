"""Figure and table twins of the paper's evaluation, on the port.

One module per paper figure or table (Figs. 2, 3, 9–15, Table I), the
campaign's own statistical acceptance run, and the beyond-paper twins
(repair_recovery, fleet_goodput, cluster_ffp, obs_overhead), each the twin
of the reference benchmark of the same name: the same sizes and the same
``Claims``, computed by :mod:`repro_torch` alone.  ``python -m repro_torch.bench.run [--quick]
[--only NAME] [--device cpu|cuda]``; results go to
``experiments/bench_torch/<name>.json``.
"""
