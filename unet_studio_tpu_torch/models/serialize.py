"""Model <-> .nz serialization (reference: main.cpp:157-233).

Tensors are stored positionally as ``tensor0..tensorN`` float matrices in
LibTorch ``parameters()`` order, in LibTorch layouts, with shape
(rows=dim0, cols=numel/dim0): the port reads and writes them as they are.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io.nz import read_nz, write_nz
from ..utils.device import resolve_device
from .dsl import UNetSpec, parse_architecture
from .unet3d import UNet3d, param_order, to_torch_layout, torch_param_shape


def load_model(path: str, device=None) -> UNet3d:
    """Read a ``.nz`` model onto ``device`` (default: the card)."""
    dev = resolve_device(device)
    nz = read_nz(path)
    channels = nz.get_array("channels", np.int64)
    architecture = nz.get_string("architecture")
    if channels is None or not architecture:
        raise ValueError(f"{path}: invalid .nz format (missing channels/architecture)")
    spec = parse_architecture(int(channels[0]), int(channels[1]), architecture)

    dim = nz.get_array("dimension", np.int64)
    voxel_size = nz.get_array("voxel_size", np.float32)
    if dim is None or voxel_size is None:
        raise ValueError(f"{path}: invalid .nz format (missing dimension/voxel_size)")

    model = UNet3d(spec)
    model.voxel_size = np.asarray(voxel_size[:3], np.float32)
    model.dim = tuple(int(v) for v in dim[:3])
    model.fov_strategy = nz.get_string("fov_strategy", "align_top")
    model.preproc = nz.get_string("preproc", "")
    model.orientation = nz.get_string("orientation", "")
    model.postproc = nz.get_string("postproc", "softmax+create_mask+argmax")
    scl = nz.get_array("single_component_label")
    if scl is not None:
        model.single_component_label = [int(v) for v in np.asarray(scl).reshape(-1)]
    te = nz.get_array("testing_errors", np.float32)
    tr = nz.get_array("training_errors", np.float32)
    model.testing_errors = [] if te is None else [float(v) for v in te]
    model.training_errors = [] if tr is None else [float(v) for v in tr]
    # reference pads training_errors to testing length (main.cpp:189)
    if len(model.training_errors) < len(model.testing_errors):
        model.training_errors += [0.0] * (
            len(model.testing_errors) - len(model.training_errors)
        )

    params = {}
    for tid, (name, layer, which) in enumerate(param_order(spec)):
        arr = nz.get_array(f"tensor{tid}")
        shape = torch_param_shape(layer, which)
        if arr is None or arr.size != int(np.prod(shape)):
            got = 0 if arr is None else arr.size
            raise ValueError(
                f"{path}: tensor size mismatch at tensor{tid} ({got} != {int(np.prod(shape))})"
            )
        params[name] = np.asarray(arr, np.float32).reshape(shape)
    model.load_params(params)
    return model.to(dev)


def save_model(path: str, model: UNet3d, sloped: bool = True) -> None:
    entries: dict[str, object] = {
        "channels": np.array([model.in_count, model.out_count], np.int32),
        "architecture": model.architecture,
        "dimension": np.array(model.dim, np.int32),
        "voxel_size": np.asarray(model.voxel_size, np.float32),
        "fov_strategy": model.fov_strategy,
        "preproc": model.preproc,
        "orientation": model.orientation,
        "postproc": model.postproc,
        "training_errors": np.asarray(model.training_errors, np.float32),
        "testing_errors": np.asarray(model.testing_errors, np.float32),
    }
    if model.single_component_label:
        entries["single_component_label"] = np.asarray(model.single_component_label, np.uint32)
    shapes: dict[str, tuple[int, int]] = {}
    sloped_keys: set[str] = set()
    params = model.params()
    for tid, (name, layer, which) in enumerate(param_order(model.spec)):
        t = params[name].detach().float().cpu().numpy()
        key = f"tensor{tid}"
        entries[key] = t.reshape(-1)
        # (rows=dim0, cols=numel/dim0), main.cpp:228-229
        shapes[key] = (t.shape[0], t.size // t.shape[0])
        if sloped:
            sloped_keys.add(key)
    write_nz(
        path,
        entries,
        shapes=shapes,
        sloped_keys=sloped_keys,
        min_size_for_slope=1024,
        precision={"training_errors": 3, "testing_errors": 3},
    )


def from_jax_params(spec: UNetSpec, params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX package's parameters (``{"encode0.0.w": array}``, DHWIO
    convs, ``(Ci,2,2,2,Co)`` conv_trans) -> the port's state dict
    (``{"encode0.0.weight": tensor}`` in torch layouts).  The inverse of
    the JAX package's ``torch_to_jax``."""
    out = {}
    for name, layer, which in param_order(spec):
        mod, i, _ = name.split(".")
        arr = to_torch_layout(layer, which, np.asarray(params_np[name]))
        out[f"{mod}.{i}.{'weight' if which == 'w' else 'bias'}"] = torch.from_numpy(arr)
    return out


def from_jax_opt_state(spec: UNetSpec, opt_state: dict) -> dict:
    """The JAX package's SGD state (``{"momentum": {name: array}, "step":
    int}``) -> the port's (``engine/optimizer.py``): momentum buffers in
    torch layouts keyed like ``UNet3d.params()``, the step as an int.  The
    buffers share the parameters' layouts, so ``from_jax_params`` maps
    them (and JAX gradients alike)."""
    sd = from_jax_params(spec, opt_state["momentum"])
    momentum = {}
    for name, _, which in param_order(spec):
        mod, i, _ = name.split(".")
        momentum[name] = sd[f"{mod}.{i}.{'weight' if which == 'w' else 'bias'}"]
    return {"momentum": momentum, "step": int(np.asarray(opt_state["step"]))}


def to_jax_opt_state(spec: UNetSpec, opt_state: dict) -> dict:
    """The port's SGD state -> the JAX package's (numpy momentum buffers
    in its layouts, DHWIO convs and (Ci,2,2,2,Co) conv_trans, keyed like
    its parameters; the step as an int64 scalar): the inverse of
    ``from_jax_opt_state``, the ``.opt`` file both packages read."""
    momentum = {}
    for name, layer, which in param_order(spec):
        arr = opt_state["momentum"][name].detach().float().cpu().numpy()
        if which == "w" and layer.kind == "conv":
            arr = arr.transpose(2, 3, 4, 1, 0)
        elif which == "w" and layer.kind == "conv_trans":
            arr = arr.transpose(0, 2, 3, 4, 1)
        momentum[name] = np.ascontiguousarray(arr)
    return {"momentum": momentum, "step": np.asarray(int(opt_state["step"]), np.int64)}


def get_model_path(model_arg: str, zoo_dir: str | None = None) -> str:
    """--model resolution: append .nz, fall back to the zoo dir
    (train.cpp:1044-1052)."""
    path = model_arg
    if not path.endswith("nz"):
        path += ".nz"
    if not os.path.exists(path) and zoo_dir:
        cand = os.path.join(zoo_dir, os.path.basename(path))
        if os.path.exists(cand):
            return cand
    return path
