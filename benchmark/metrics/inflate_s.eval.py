"""inflate_s.eval: Seconds per volume of the gzip read inside the reader thread's
``read_nifti`` (the program's ``eval.read.inflate`` spans under its ``eval.read``
spans) in the profiled volumes."""

import sys


def read(obs: dict):
    prof = sys.modules.get("unet_studio_tpu_torch.utils.profiling")
    if obs.get("trace") is None or not hasattr(prof, "records"):
        return None
    recs = prof.records()
    reads = {r.id for r in recs if r.name == "eval.read"}
    if not reads:
        return None
    return sum(r.end_ns - r.start_ns for r in recs
               if r.name == "eval.read.inflate" and r.parent in reads) / 1e9 / len(reads)
