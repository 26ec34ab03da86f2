"""Device selection and the boot-time probe (the check_cuda analog,
cuda.cu:34-74).  The port runs on the card unless the caller asks for the
CPU; with no card and no such request it raises rather than carry on
on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``""``/``"cuda"`` -> the card (raises if there is none);
    ``"cpu"`` -> the CPU, only when asked for."""
    dev = torch.device("cuda" if device in (None, "") else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    return dev


def check_cuda(device=None) -> str:
    """Probe the card, run a tiny self-test and print its capabilities.
    Returns an empty string on success, an error message otherwise."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ""
    try:
        props = torch.cuda.get_device_properties(dev)
        print(f"device {dev}: {props.name}, {props.total_memory / 2**30:.1f} GiB, "
              f"{props.multi_processor_count} SMs, sm_{props.major}{props.minor}",
              flush=True)
        x = torch.ones((8, 128), device=dev, dtype=torch.bfloat16)
        if not bool(torch.isfinite(x @ x.T).all()):
            return "device self-test produced non-finite values"
        return ""
    except RuntimeError as e:
        return f"accelerator probe failed: {e}"
