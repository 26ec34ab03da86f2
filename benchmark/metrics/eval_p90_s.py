"""eval_p90_s: The 90th percentile of the requests' latencies in the window, each
from its send to its labels on the host (closed loop only)."""

import numpy as np


def read(obs: dict):
    lat = obs.get("latencies")
    if not lat:
        return None
    return float(np.percentile(lat, 90))
