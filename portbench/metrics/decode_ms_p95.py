"""decode_ms_p95: the 95th percentile over every call of the window of the host
time from the call to its numpy result, in milliseconds."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx["latencies_s"]) * 1e3, 95))
