"""The 90th percentile, in ms, of the time to first token of every request
whose first token landed in the window, each from when it was due."""
import numpy as np


def read(rec, metric):
    ttft = rec.get("ttft_s")
    return 1e3 * float(np.percentile(ttft, 90)) if ttft else None
