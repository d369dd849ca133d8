"""One module per model family (``bridges/<family>.py``), found by the
configuration's ``family``: the benchmark's layout of the family's weights
(``parts``, ``part_leaves``) and the bridge to the port (``lm_config``,
``program_params``).  Only ``lm_config`` imports the port."""
