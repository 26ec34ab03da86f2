"""infer_s.eval: Seconds per volume of ``EvaluateEngine.infer`` (the device function up
to its copy to the host), host clock."""

import numpy as np


def read(obs: dict):
    r = obs.get("infer_s")
    return float(np.mean(r)) if r else None
