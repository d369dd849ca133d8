"""Server loop: mean active slots over the window's steps, as a share (%)
of the decode slots (the server's StepRecords)."""


def read(rec, metric):
    steps = rec.get("steps")
    if not steps:
        return None
    return 100.0 * sum(s["active"] for s in steps) / (len(steps) * rec["n_slots"])
