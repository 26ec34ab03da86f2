"""optimizer_s.train: Optimizer seconds per step (the clip and SGD), from the train step's
``timings``."""


def read(obs: dict):
    t = obs.get("timings")
    if not t or "optimizer_s" not in t:
        return None
    return t["optimizer_s"]
