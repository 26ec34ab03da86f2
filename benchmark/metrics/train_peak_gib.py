"""train_peak_gib: ``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, in GiB."""


def read(obs: dict):
    if not obs.get("peak_bytes_window"):
        return None
    return obs["peak_bytes_window"] / 2**30
