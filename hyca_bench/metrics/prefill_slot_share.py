"""Server loop: the share (%) of active slot-steps of the window that fed a
prompt token (token-level prefill through the decode step), from the
server's StepRecords and the tokens each step generated."""


def read(rec, metric):
    steps = rec.get("steps")
    active = sum(s["active"] for s in steps or ())
    return 100.0 * sum(s["prompt_fed"] for s in steps) / active if active else None
