"""Inference engine (reference: evaluate.cpp:181-517 + TIPL evalution_set;
the counterpart of unet_studio_tpu/engine/evaluate.py).

Pipeline per volume, 3 stages pipelined like the reference's 3 threads
with <= 6 volumes of lookahead (evaluate.cpp:192):

  read  : NIfTI load -> LPS canonicalization (flip_swap recorded) ->
          model.preproc -> model.orientation ops -> per-channel max
          normalization
  infer : on the device: FOV resample onto the model grid -> forward
          (level 0 only) -> resample back to the native grid -> softmax
          -> label / fg; label and fg come back to the host, the (C, D,
          H, W) probabilities stay on the device until asked for
  output: host morphology (single_component_label reduction), files

Output semantics follow the JAX package: ``fg`` is rounded to bfloat16
before it leaves the device, and ``model.orientation`` is applied at
read time and not reversed at save time.
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.nifti import apply_flip_swap, canonicalize_lps, read_nifti, write_nifti
from ..models.unet3d import UNet3d, forward_fused
from ..ops.morphology import (
    anisotropic_diffusion,
    apply_single_component,
    defragment_by_size_ratio,
    gaussian_smooth,
    smooth_mask,
)
from ..ops.resample import diag_affine_matrices, model_grid_transform, separable_resample
from ..utils.device import resolve_device
from ..utils.profiling import span

# preproc operations vocabulary (evaluate.cpp:5-17)
OPERATIONS = (
    "none",
    "gaussian_filter",
    "smoothing_filter",
    "normalize",
    "upsampling",
    "downsampling",
    "flip_x",
    "flip_y",
    "flip_z",
    "swap_xy",
    "swap_yz",
    "swap_xz",
)


@dataclass
class EvalCase:
    """The observable surface of TIPL's ``evalution_set``."""

    path: str = ""
    image_dim: tuple = ()  # (D,H,W) native canonical grid
    image_vs: np.ndarray | None = None
    untouched_affine: np.ndarray | None = None
    untouched_vs: np.ndarray | None = None
    flip_swap: list = field(default_factory=list)
    model_io: list = field(default_factory=list)  # host inputs (D,H,W,C)
    label: np.ndarray | None = None  # (D,H,W) argmax labels, native grid
    fg_prob: np.ndarray | None = None  # (D,H,W) foreground probability
    mask: np.ndarray | None = None
    is_label: bool = True
    error_msg: str = ""
    seq: int = -1  # the volume's place in its ``run`` (the ids of its spans, with ``path``)
    _device_prob: object = None  # (C,D,H,W) on the device, fetched lazily
    _label_prob: np.ndarray | None = None

    @property
    def label_prob(self) -> np.ndarray | None:
        """(C,D,H,W) probabilities; copied from the device on first use."""
        if self._label_prob is None and self._device_prob is not None:
            self._label_prob = self._device_prob.cpu().numpy()
            self._device_prob = None
        return self._label_prob

    @label_prob.setter
    def label_prob(self, value) -> None:
        self._label_prob = value
        self._device_prob = None


def run_preproc_op(vol: np.ndarray, op: str) -> np.ndarray:
    """One preproc operation on a (D,H,W) volume (OPERATIONS vocabulary)."""
    if op in ("", "none"):
        return vol
    if op == "gaussian_filter":
        return gaussian_smooth(vol)
    if op == "smoothing_filter":
        from scipy import ndimage

        return ndimage.uniform_filter(vol.astype(np.float32), size=3, mode="nearest")
    if op == "normalize":
        mx = vol.max()
        return vol / mx if mx > 0 else vol
    if op == "upsampling":
        return np.repeat(np.repeat(np.repeat(vol, 2, 0), 2, 1), 2, 2)
    if op == "downsampling":
        d, h, w = (s // 2 * 2 for s in vol.shape)
        v = vol[:d, :h, :w].reshape(d // 2, 2, h // 2, 2, w // 2, 2)
        return v.mean(axis=(1, 3, 5))
    if op in ("flip_x", "flip_y", "flip_z", "swap_xy", "swap_yz", "swap_xz"):
        return apply_flip_swap(vol, [op])
    raise ValueError(f"unknown preproc operation {op!r}")


def make_infer_graph(model: UNet3d, image_dhw: tuple, image_vs, compute_dtype=torch.bfloat16):
    """The evaluate path's device function for one native grid:
    ``run(chunk)`` with ``chunk`` a (D, H, W, C) f32 tensor on the
    model's device -> (label int16, prob (C,D,H,W) f32, fg bfloat16), all
    on that device.  FOV resample -> forward (level 0) -> inverse
    resample -> softmax postproc (evaluate.cpp:211-246)."""
    model_dhw = model.dim_dhw
    image_xyz = (image_dhw[2], image_dhw[1], image_dhw[0])
    # model voxel -> image voxel transform; invert for the way back
    m = model_grid_transform(
        image_xyz, image_vs, model.dim, model.voxel_size, model.fov_strategy
    ).astype(np.float64)
    fwd34 = np.zeros((3, 4), np.float32)
    fwd34[:, :3] = np.diag(m[:, :3].diagonal())
    fwd34[:, 3] = m[:, 3]
    inv34 = np.zeros((3, 4), np.float32)
    inv34[0, 0] = 1.0 / m[0, 0]
    inv34[1, 1] = 1.0 / m[1, 1]
    inv34[2, 2] = 1.0 / m[2, 2]
    inv34[:, 3] = -m[:, 3] / m[:, :3].diagonal()
    fwd_mats = diag_affine_matrices(fwd34, image_dhw, model_dhw)
    inv_mats = diag_affine_matrices(inv34, model_dhw, image_dhw)
    spec = model.spec
    postproc = model.postproc

    @torch.no_grad()
    def run(chunk: torch.Tensor):
        model_in = separable_resample(chunk, *fwd_mats)  # (Dm,Hm,Wm,C)
        outs = forward_fused(spec, model.params(), model_in[None],
                             compute_dtype=compute_dtype, level0_only=True)
        logits = outs[0][0]  # (Dm,Hm,Wm,out) f32
        native = separable_resample(logits, *inv_mats)  # (D,H,W,out)
        native_cl = torch.movedim(native, -1, 0)
        prob = torch.softmax(native_cl, dim=0) if "softmax" in postproc else native_cl
        fg = 1.0 - prob[0]
        if "argmax" in postproc:
            label = torch.where(fg > 0.5, torch.argmax(prob, dim=0).to(torch.int16),
                                torch.zeros((), dtype=torch.int16, device=fg.device))
        else:
            label = torch.zeros(tuple(image_dhw), dtype=torch.int16, device=fg.device)
        return label, prob, fg.to(torch.bfloat16)

    return run


class EvaluateEngine:
    """Loads a model once onto ``device`` (default: the card) and
    evaluates any number of volumes."""

    def __init__(self, model: UNet3d, compute_dtype=torch.bfloat16, lookahead: int = 6,
                 post_workers: int = 2, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.compute_dtype = compute_dtype
        self.lookahead = lookahead
        self.post_workers = max(1, int(post_workers))
        self.error_msg = ""
        self._infer_cache: dict = {}

    # -- stage 1: read + preprocess -----------------------------------------

    def preprocess(self, path: str) -> EvalCase:
        case = EvalCase(path=str(path))
        img = read_nifti(path)
        case.untouched_affine = img.affine.copy()
        case.untouched_vs = img.voxel_size.copy()
        with span("eval.read.canonicalize"):
            img = canonicalize_lps(img)
        case.flip_swap = img.flip_swap

        with span("eval.read.normalize"):
            data = img.data.astype(np.float32)
            vols = data[None] if data.ndim == 3 else data  # (T,D,H,W)
            for op in filter(None, self.model.preproc.split("+")):
                vols = np.stack([run_preproc_op(v, op) for v in vols])
            for op in filter(None, self.model.orientation.split("+")):
                vols = np.stack([run_preproc_op(v, op) for v in vols])

            case.image_dim = vols.shape[1:]
            case.image_vs = img.voxel_size
            in_c = self.model.in_count
            t = vols.shape[0]
            if t % in_c != 0:
                case.error_msg = f"{path}: {t} volumes not divisible by model in_count {in_c}"
                return case
            for g in range(t // in_c):
                chunk = np.moveaxis(vols[g * in_c : (g + 1) * in_c], 0, -1)  # (D,H,W,C)
                mx = chunk.reshape(-1, in_c).max(axis=0)
                mx[mx <= 0] = 1.0
                case.model_io.append(np.ascontiguousarray(chunk / mx, np.float32))
        return case

    # -- stage 2: device inference -------------------------------------------

    def _infer_fn(self, image_dhw: tuple, image_vs):
        key = (image_dhw, tuple(np.round(np.asarray(image_vs, np.float64), 5)))
        if key not in self._infer_cache:
            self._infer_cache[key] = make_infer_graph(
                self.model, image_dhw, image_vs, self.compute_dtype
            )
        return self._infer_cache[key]

    def infer(self, case: EvalCase, fetch_prob: bool = False) -> EvalCase:
        """Run the device function.  ``label``/``fg_prob`` come back to the
        host; the (C,D,H,W) probabilities stay on the device unless
        ``fetch_prob`` or a consumer asks (``EvalCase.label_prob``)."""
        if case.error_msg or not case.model_io:
            return case
        with span("eval.infer", seq=case.seq, path=case.path):
            run = self._infer_fn(tuple(case.image_dim), case.image_vs)
            labels, probs, fgs = [], [], []
            for chunk in case.model_io:
                with span("eval.infer.h2d"):
                    x = torch.from_numpy(chunk).to(self.device)
                with span("eval.infer.forward"):
                    label, prob, fg = run(x)
                labels.append(label)
                probs.append(prob)
                fgs.append(fg)
            with span("eval.infer.fetch"):
                case.label = torch.cat(labels, 0).cpu().numpy().astype(np.int32)
                # multi-chunk cases stack along D = axis 1 of the (C,D,H,W) prob
                case._device_prob = torch.cat(probs, 1)
                case.fg_prob = torch.cat(fgs, 0).float().cpu().numpy()
                if fetch_prob:
                    case.label_prob  # noqa: B018  (property fetch)
        return case

    # -- stage 3: host postproc ------------------------------------------------

    def postprocess(self, case: EvalCase) -> EvalCase:
        if case.error_msg or case.label is None:
            return case
        with span("eval.post", seq=case.seq, path=case.path):
            if "create_mask" in self.model.postproc:
                case.mask = (case.fg_prob > 0.5).astype(np.uint8)
            if self.model.single_component_label:
                case.label = apply_single_component(
                    case.label, self.model.single_component_label
                ).astype(np.int32)
        return case

    # -- interactive postproc actions (evaluate.cpp:303-383) -------------------

    def proc_action(self, case: EvalCase, cmd: str, param1: float = 0.0, param2: float = 0.0):
        prob = case.label_prob
        if prob is None:
            return
        if cmd == "argmax":
            case.label = np.where(case.fg_prob > param1, np.argmax(prob, axis=0), 0).astype(
                np.int32
            )
            case.is_label = True
            return
        if cmd == "upper_threshold":
            case.label_prob = np.minimum(prob, param1)
        elif cmd == "lower_threshold":
            case.label_prob = np.maximum(prob, param1)
        elif cmd == "minus":
            case.label_prob = prob - param1
        elif cmd == "defragment_each":
            out = prob.copy()
            for c in range(prob.shape[0]):
                m = prob[c] > param1
                keep = defragment_by_size_ratio(m)
                out[c][m & ~keep] = 0
            case.label_prob = out
        elif cmd == "normalize_each":
            out = prob.copy()
            for c in range(prob.shape[0]):
                mx = out[c].max()
                if mx > 0:
                    out[c] /= mx
            case.label_prob = out
        elif cmd == "gaussian_smoothing":
            case.label_prob = np.stack([gaussian_smooth(p) for p in prob])
        elif cmd == "binarize":
            case.label_prob = (prob > param1).astype(np.float32)
        elif cmd == "soft_max":
            e = np.exp(prob - prob.max(axis=0, keepdims=True))
            sm = e / e.sum(axis=0, keepdims=True)
            case.label_prob = np.where(sm > param1, sm, 0.0).astype(np.float32)
        elif cmd == "defragment":
            # summed-probability defragment (postproc.txt:1-3): threshold
            # the channel-summed probability at param1, smooth the mask
            # param2 times, defragment it, zero the background in every
            # channel (mainwindow_evaluation.cpp:513-517)
            m = prob.sum(axis=0) > param1
            for _ in range(int(param2)):
                m = smooth_mask(m)
            keep = defragment_by_size_ratio(m)
            out = prob.copy()
            out[:, ~keep] = 0
            case.label_prob = out
        elif cmd == "anisotropic_smoothing":
            case.label_prob = np.stack([anisotropic_diffusion(p) for p in prob])
        else:
            # unknown commands log and continue (evaluate.cpp:372)
            logging.getLogger(__name__).error("unknown command %s", cmd)
            return
        case.is_label = False

    # -- file output (evaluate.cpp:424-458) -------------------------------------

    def save_case(self, case: EvalCase, out_path: str, output_type: int = 0) -> bool:
        def undo(data):
            return apply_flip_swap(data, case.flip_swap, reverse=True)

        def write(data):
            with span("eval.save.write"):
                write_nifti(out_path, data, case.untouched_vs, case.untouched_affine)

        with span("eval.save", seq=case.seq, path=case.path):
            if output_type == 0:
                write(undo(case.label.astype(np.int16)))
            elif output_type == 1:
                orig = read_nifti(case.path).data.astype(np.float32)
                fg = undo(case.fg_prob)
                if orig.ndim == 4:
                    fg = fg[None]
                write(orig * fg)
            elif output_type == 2:
                write(undo(case.fg_prob.astype(np.float32)))
            elif output_type == 3:
                write(np.stack([undo(p) for p in case.label_prob]))
            else:
                return False
        return True

    # -- pipelined run -----------------------------------------------------------

    def run(self, paths: list[str]):
        """Yield processed EvalCases in order through a 3-stage pipeline
        (evaluate.cpp:192,250-299): a reader thread prefetches up to
        ``lookahead`` volumes, the calling thread drives the device, and
        host post-processing runs on a worker pool overlapped with the
        next volume's inference."""
        q: queue.Queue = queue.Queue(maxsize=self.lookahead)

        def reader():
            for i, p in enumerate(paths):
                with span("eval.read", seq=i, path=str(p)):
                    try:
                        c = self.preprocess(p)
                    except Exception as e:  # noqa: BLE001  (reported on the case)
                        c = EvalCase(path=str(p))
                        c.error_msg = f"{p}: {e}"
                c.seq = i
                q.put(c)
            q.put(None)

        t = threading.Thread(target=reader, daemon=True, name="unet-eval-reader")
        t.start()

        def finish(case, fut):
            if fut is not None:
                try:
                    fut.result()
                except Exception as e:  # noqa: BLE001  (reported on the case)
                    case.error_msg = case.error_msg or f"{case.path}: {e}"
            if case.error_msg and not self.error_msg:
                self.error_msg = case.error_msg
            return case

        pending: deque = deque()
        with ThreadPoolExecutor(max_workers=self.post_workers,
                                thread_name_prefix="unet-output") as post:
            while True:
                with span("eval.wait") as waited:
                    case = q.get()
                    if case is not None:
                        waited.tag(seq=case.seq, path=case.path)
                if case is None:
                    break
                fut = None
                if not case.error_msg:
                    try:
                        self.infer(case)
                        fut = post.submit(self.postprocess, case)
                    except Exception as e:  # noqa: BLE001  (reported on the case)
                        case.error_msg = f"{case.path}: {e}"
                pending.append((case, fut))
                # keep at most 2 in flight; yield in order once done
                while pending and (
                    len(pending) > 2 or pending[0][1] is None or pending[0][1].done()
                ):
                    yield finish(*pending.popleft())
            while pending:
                yield finish(*pending.popleft())
        t.join()
