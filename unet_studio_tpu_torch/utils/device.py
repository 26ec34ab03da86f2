"""Device selection, the boot-time probe (the check_cuda analog,
cuda.cu:34-74) and multi-host initialization.  The port runs on the card
unless the caller asks for the CPU; with no card and no such request it
raises rather than carry on on the CPU."""

from __future__ import annotations

import os

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


def init_multihost(coordinator: str | None = None, *, device=None,
                   backend: str | None = None) -> None:
    """Join this process to the ranks of a multi-host (or multi-process)
    run: ``torch.distributed.init_process_group`` at
    ``tcp://{coordinator}`` (``env://`` without one), with its rank and
    world size from ``RANK`` and ``WORLD_SIZE`` (torchrun's names).  The
    backend is NCCL where every rank has a card of its own, gloo for
    ``device="cpu"``; ranks that share a card pass ``backend="gloo"``.  A
    no-op when the group is already initialized, as the JAX package's."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(f"init_multihost needs RANK and WORLD_SIZE in the environment "
                           f"({e.args[0]} is not set)") from None
    if backend is None:
        backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}" if coordinator
                            else "env://", rank=rank, world_size=world)
