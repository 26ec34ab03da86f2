"""save_s.eval: Seconds per volume of ``EvaluateEngine.save_case`` on the driving
thread, host clock."""

import numpy as np


def read(obs: dict):
    r = obs.get("save_s")
    return float(np.mean(r)) if r else None
