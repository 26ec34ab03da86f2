"""mfu.train: Model FLOPs (3 x the forward's, no recompute) of the items finished in
the window over the window seconds times the card's peak bf16 FLOP/s."""


def read(obs: dict):
    peaks = obs.get("peaks")
    if not peaks or not obs.get("items"):
        return None
    return 100.0 * 3 * obs["fwd_flops"] * obs["items"] / (obs["window_s"] * peaks[0])
