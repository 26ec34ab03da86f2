"""mfu.eval: The forward's FLOPs (level 0's head, at the model grid) of the volumes
finished in the window over the window seconds times the card's peak
bf16 FLOP/s."""


def read(obs: dict):
    peaks = obs.get("peaks")
    if not peaks or not obs.get("vols"):
        return None
    return 100.0 * obs["fwd_flops"] * obs["vols"] / (obs["window_s"] * peaks[0])
