"""The 80th percentile, in ms, of the time to first token of every request
whose first token landed in the window, each from when it was due (for a
cell whose window holds too few requests for a p90 with ten beyond it)."""
import numpy as np


def read(rec, metric):
    ttft = rec.get("ttft_s")
    return 1e3 * float(np.percentile(ttft, 80)) if ttft else None
