"""idle_share.train: The share of a profiled epoch in which no kernel, copy or memset ran
on the card: 1 - busy / window."""


def read(obs: dict):
    tr = obs.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
