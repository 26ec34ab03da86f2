"""read_wait_s.eval: Seconds per volume that the driving thread of ``EvaluateEngine.run``
waited on its reader (the program's ``eval.wait`` spans) in the profiled volumes,
volumes counted by the program's ``eval.read`` spans."""

import sys


def read(obs: dict):
    prof = sys.modules.get("unet_studio_tpu_torch.utils.profiling")
    if obs.get("trace") is None or not hasattr(prof, "records"):
        return None
    recs = prof.records()
    vols = sum(r.name == "eval.read" for r in recs)
    if not vols:
        return None
    return sum(r.end_ns - r.start_ns for r in recs if r.name == "eval.wait") / 1e9 / vols
