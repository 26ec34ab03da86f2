"""train_items_per_s: Items finished in whole epochs over the time those epochs took in the
window (host clock)."""


def read(obs: dict):
    if not obs.get("items"):
        return None
    return obs["items"] / obs["window_s"]
