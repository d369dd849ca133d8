"""Output tokens generated in the window, per second of the window."""


def read(rec, metric):
    return rec["tokens"] / rec["window_s"] if rec["kind"] == "chat" else None
