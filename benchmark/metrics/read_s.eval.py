"""read_s.eval: Seconds per volume of ``EvaluateEngine.preprocess`` (the NIfTI read,
the canonical order, the normalization) on the reader thread, host clock."""

import numpy as np


def read(obs: dict):
    r = obs.get("read_s")
    return float(np.mean(r)) if r else None
