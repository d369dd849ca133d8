"""The 95th percentile, in ms, of every gap between consecutive output
tokens of a request within the window."""
import numpy as np


def read(rec, metric):
    itl = rec.get("itl_s")
    return 1e3 * float(np.percentile(itl, 95)) if itl else None
