"""The 95th percentile of the host milliseconds each query of the window
took, from its call to the program's return after its host sync (numpy's
linear interpolation)."""

import numpy as np


def read(records):
    queries = records["queries"]
    if not queries:
        return None
    return float(np.percentile([1e3 * q["wall_s"] for q in queries], 95))
