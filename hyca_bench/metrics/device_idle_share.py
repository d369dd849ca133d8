"""Device: the share (%) of the traced window in which no kernel, copy or
fill ran on the card (``torch.profiler``)."""


def read(rec, metric):
    prof = rec.get("profile")
    if not prof or not prof.get("device"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
