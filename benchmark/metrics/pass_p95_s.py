"""The 95th percentile of the wall of every pass of the window (linear
interpolation between order statistics)."""

import numpy as np


def read(rec):
    return float(np.percentile([p.wall for p in rec.passes], 95))
