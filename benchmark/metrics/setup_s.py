"""setup_s: The set-up time: from the process start to the window (loading, the
weights and inputs from the seed, the engine, the warm-up)."""


def read(obs: dict):
    return obs.get("setup_s")
