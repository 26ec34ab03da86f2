"""Model surgery: output-channel reordering and out_count padding
(reference: mainwindow_training.cpp:721-779 and :352-364; the counterpart
of unet_studio_tpu/models/surgery.py).

Both act on the deep-supervision heads (the ks1 ``output`` layers), whose
output-channel dimension is the class dimension: dim 0 of a conv weight
``(O, I, k, k, k)`` and of a norm's ``(C,)``, dim 1 of a transposed conv's
``(I, O, 2, 2, 2)``.  Each returns a new ``UNet3d`` on the model's device.
"""

from __future__ import annotations

import numpy as np

from .dsl import LayerSpec, parse_architecture
from .unet3d import UNet3d, init_params, init_state, param_order


def _out_dim(layer: LayerSpec, which: str) -> int:
    return 1 if layer.kind == "conv_trans" and which == "w" else 0


def _host_params(model: UNet3d) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in model.params().items()}


def _with_metadata(spec, params: dict, model: UNet3d, state: dict, errors: bool) -> UNet3d:
    out = UNet3d(spec)
    out.load_params(params)
    out.state = state
    out.voxel_size = np.array(model.voxel_size, np.float32)
    out.dim = tuple(model.dim)
    out.fov_strategy = model.fov_strategy
    out.preproc = model.preproc
    out.orientation = model.orientation
    out.postproc = model.postproc
    if errors:
        out.single_component_label = list(model.single_component_label)
        out.testing_errors = list(model.testing_errors)
        out.training_errors = list(model.training_errors)
    return out.to(model.device)


def reorder_output_channels(model: UNet3d, new_order: list[int]) -> UNet3d:
    """Permute the class channels of every deep-supervision head:
    ``new_order[k]`` is the old class that becomes class k (the GUI
    renumbers label classes this way without retraining,
    mainwindow_training.cpp:721-779)."""
    if sorted(new_order) != list(range(model.out_count)):
        raise ValueError(f"new_order must be a permutation of 0..{model.out_count - 1}")
    order = np.asarray(new_order)
    params = _host_params(model)
    for name, layer, which in param_order(model.spec):
        if name.startswith("output"):
            params[name] = np.take(params[name], order, axis=_out_dim(layer, which))
    return _with_metadata(model.spec, params, model, dict(model.state), errors=True)


def pad_out_count(model: UNet3d, new_out_count: int, seed: int = 0) -> UNet3d:
    """Grow the class dimension: rebuild with the architecture's output
    token widened, then copy every parameter whose shape matches, or
    differs only in its class dimension, into the leading slice (the GUI's
    rebuild and copy_from, mainwindow_training.cpp:352-364).  New class
    channels keep their fresh initialization."""
    if new_out_count < model.out_count:
        raise ValueError("pad_out_count only grows the class dimension")
    arch = model.architecture.replace(f"conv{model.out_count},ks1,stride1",
                                      f"conv{new_out_count},ks1,stride1")
    spec = parse_architecture(model.in_count, new_out_count, arch)
    params = init_params(spec, seed)
    old = _host_params(model)
    for name, layer, which in param_order(spec):
        if name not in old:
            continue
        nv, ov = params[name], old[name]
        if nv.shape == ov.shape:
            params[name] = ov
            continue
        d = _out_dim(layer, which)
        if nv.ndim == ov.ndim and all(a == b for i, (a, b) in enumerate(zip(nv.shape, ov.shape))
                                      if i != d):
            nv = nv.copy()
            nv[(slice(None),) * d + (slice(0, ov.shape[d]),)] = ov
            params[name] = nv
    return _with_metadata(spec, params, model, init_state(spec), errors=False)
