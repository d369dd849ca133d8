"""The harness: what every cell shares (the spec and its lookups, the
inputs drawn from the seed, the port's server, the trace reduction and the
judgement of the checks).  Nothing here is specific to one configuration,
traffic mix, kind of mix, arrival process, model family or per-layer
metric: those are files of their own under ``configs/``, ``traffic/``,
``limits/``, ``drivers/``, ``arrivals/``, ``bridges/``, ``counts/``,
``reference/`` and ``metrics/``."""
