"""One module per kind of mix (``drivers/<kind>.py``), found by the mix's
``kind``.  Each has:

* ``Driver(cfg, mix, seed, device, tracing)``: builds the port's objects,
  warms up the cell's shapes; ``run(seconds)`` measures one window and
  returns its record (``window_s``, ``tokens``, ``model_flops``,
  ``profile``, ``profiled_calls`` and the kind's own keys, read by
  ``metrics/``); ``unrepaired_faults()``; ``free()``;
* ``compare(cfg, mix, seed, device, res, quant=None)``: the numbers the
  check can compare, from the plain reference after the program is freed
  (with ``quant``, the reference in that precision in the program's place:
  the control);
* ``tally(res)``: (attempted, failed, samples) of the window."""
