"""synth_syncs.train: Host syncs per item inside the program's ``synth`` spans of the
profiled epoch: the ``sync`` counts of each ``synth`` span and of the spans under it,
from the program's tracer (torch's sync debug mode, read while a profile runs)."""

import sys


def read(obs: dict):
    prof = sys.modules.get("unet_studio_tpu_torch.utils.profiling")
    if obs.get("trace") is None or not hasattr(prof, "records"):
        return None
    recs = prof.records()
    by_id = {r.id: r for r in recs}
    items = sum(r.name == "synth" for r in recs)
    if not items:
        return None

    def in_synth(r):
        while r is not None:
            if r.name == "synth":
                return True
            r = by_id.get(r.parent)
        return False

    return sum(r.counts.get("sync", 0) for r in recs if in_synth(r)) / items
