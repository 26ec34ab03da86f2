"""kernel_roofline.train: The share of its roofline that the forward and backward work reaches:
the least time of that work (``cost.least_seconds``, per layer the
larger of FLOPs / peak and bytes / peak, summed) over the device time of
the kernels of one profiled epoch that ran outside the synthesis,
validation and optimizer spans (the forward, loss and backward)."""


def read(obs: dict):
    tr, least = obs.get("trace"), obs.get("least_s_item")
    if tr is None or least is None:
        return None
    stages = tr.stage_seconds()
    dev = stages.get("", 0.0)
    if dev <= 0:
        return None
    return 100.0 * least * obs["profiled_items"] / dev
