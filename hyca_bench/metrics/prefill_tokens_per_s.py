"""Prompt tokens prefilled in the window, per second of the window."""


def read(rec, metric):
    return rec["tokens"] / rec["window_s"] if rec["kind"] == "prefill" else None
