"""fwd_bwd_s.train: Training forward and backward seconds per item (the loss included),
from the train step's ``timings`` over one epoch."""


def read(obs: dict):
    t = obs.get("timings")
    if not t:
        return None
    return (t["forward_s"] + t["backward_s"]) / obs["profiled_items"]
