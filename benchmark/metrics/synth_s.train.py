"""synth_s.train: Synthesis seconds per item (simulation, augmentation, warp), from the
train step's own ``timings`` (synchronized) over one epoch."""


def read(obs: dict):
    t = obs.get("timings")
    if not t:
        return None
    return t["synth_s"] / obs["profiled_items"]
