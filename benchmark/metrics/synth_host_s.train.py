"""synth_host_s.train: Host seconds per item of the program's own ``synth`` spans (one
an item, nothing synchronized) in the profiled epoch, from its tracer's last stretch."""

import sys


def read(obs: dict):
    prof = sys.modules.get("unet_studio_tpu_torch.utils.profiling")
    if obs.get("trace") is None or not hasattr(prof, "records"):
        return None
    synth = [r for r in prof.records() if r.name == "synth"]
    if not synth:
        return None
    return sum(r.end_ns - r.start_ns for r in synth) / 1e9 / len(synth)
