"""synth_idle_s.train: Seconds per item in which the card ran no kernel, copy or memset
inside the program's ``unet.synth`` ranges of the profiled epoch, on the trace's clock
(the ranges are the trace's own: the thread that runs the synthesis runs the profile)."""


def read(obs: dict):
    tr = obs.get("trace")
    if tr is None:
        return None
    spans = [(s, t) for s, t, name in tr._host
             if name == "unet.synth" and s >= tr.t0 and t <= tr.t1]
    if not spans:
        return None
    busy = []
    for s, t, _, _ in tr.kernels:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    idle = 0.0
    for s, t in spans:
        idle += (t - s) - sum(max(0.0, min(t, b1) - max(s, b0)) for b0, b1 in busy
                              if b1 > s and b0 < t)
    return idle / 1e6 / len(spans)
