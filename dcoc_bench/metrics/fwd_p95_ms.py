"""``fwd_p95_ms``: the 95th percentile, over every request of the
window, of the host time from a request's start to its logits on the
host (linear interpolation between order statistics)."""
import numpy as np


def read(run):
    lat = run.obs.get("latencies")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
