"""eval_vols_per_s: Volumes finished over the time they took in the window (host clock)."""


def read(obs: dict):
    if not obs.get("vols"):
        return None
    return obs["vols"] / obs["window_s"]
