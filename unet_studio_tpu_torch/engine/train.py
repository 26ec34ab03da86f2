"""Training engine (the counterpart of unet_studio_tpu/engine/train.py;
reference: train_unet, train.hpp:64-113, train.cpp:259-1010).

Per step (``TrainStep``), for each item in turn: on the device and
without autograd, contrast simulation (template or subject variant) and
the visual-perception augmentation, whose warp is the Hopper kernel of
``ops/warp.py``; then the training forward through the kernels' autograd
Functions, the deep-supervision loss and the backward (gradients
accumulated in f32); then /batch_size, clip at 12 and one SGD-nesterov
step, as the JAX package's ``device_step`` does.

``TrainEngine`` runs the epochs around it: the BIDS pairs, the template
RAM cache, the batch of epoch e + 1 assembled on a reader thread while
epoch e trains, validation on the held-out templates into
``testing_errors``, an autosave of ``.nz`` + ``.opt`` every 100 epochs and
the resume at epoch ``(len(testing_errors) // 3) % epoch``.  One device:
data parallelism across cards and several hosts are not ported yet.

Determinism and resume: sample ``seed_id = epoch * batch_size + slot``
draws its read index from ``np.random.default_rng(seed)`` advanced per
seed_id (train.cpp:394-399), and its simulation and augmentation from
``np.random.default_rng([seed, seed_id])`` (``item_rng``), so a restart
from a checkpoint replays the same items.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.bids import TrainingDataset, load_pair_on_model_grid, shift_subject_label
from ..models.serialize import from_jax_opt_state, save_model, to_jax_opt_state
from ..models.unet3d import UNet3d, forward_fused, forward_train
from ..ops.augment import AugOptions, draw_augmentation, visual_perception_augmentation
from ..ops.losses import calc_losses, deep_supervision_loss
from ..ops.simulate import (
    draw_simulation,
    simulate_modality_subject,
    simulate_modality_template,
)
from ..utils.device import resolve_device
from .optimizer import SGDConfig, init_opt_state, poly_lr, sgd_step


@dataclass
class TrainParam:
    """training_param (train.hpp:8-30)."""

    image_file_name: list[str] = field(default_factory=list)
    label_file_name: list[str] = field(default_factory=list)
    batch_size: int = 32
    epoch: int = 10000
    learning_rate: float = 1e-3
    seed: int = 0
    is_label: bool = True
    cost_ce: bool = True
    cost_dice: bool = True
    cost_mse: bool = True
    options: AugOptions = field(default_factory=AugOptions)
    compute_dtype: str = "bfloat16"  # bf16 compute, f32 master weights


def item_rng(seed: int, seed_id: int) -> np.random.Generator:
    """The generator of sample ``seed_id``'s simulation and augmentation
    draws: ``np.random.default_rng([seed, seed_id])``."""
    return np.random.default_rng([int(seed), int(seed_id)])


class TrainStep:
    """``step(opt_state, images, labels, need_shift, lr, is_template=...,
    seeds=...)`` -> (opt_state, metrics, loss): the parameters of the model
    are updated in place; ``metrics`` is [ce_sum, dice_sum, mse_sum, count]
    over the recorded items (the level-0 losses, the reference's training
    errors: every item without subject data, else the subject items,
    train.cpp:676-682) and ``loss`` the sum of the items' deep-supervision
    losses, both f32 on the device.

    ``images`` (B, D, H, W, C) float, ``labels`` (B, D, H, W) class
    indices, ``need_shift`` (B,) bools: with ``any_shift``, such an item's
    loss collapses its first ``collapse_k`` classes.  ``seeds``, one
    ``(seed, seed_id)`` per item, makes the step synthesize each item
    first (``synthesize``) from ``item_rng``; without it the items are
    taken as already synthesized.  ``is_template`` (B,) picks the
    simulation per item where there is subject data.  ``timings``, a
    dict, receives the step's synthesis, forward, backward and optimizer
    seconds (the device is synchronized between them)."""

    def __init__(self, model: UNet3d, param: TrainParam, *, any_shift: bool = False,
                 collapse_k: int = 1, has_subjects: bool = False, device=None):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model is on {model.device}, the step on {dev}")
        self.device = model.device
        self.spec = model.spec
        self.n_classes = model.out_count
        self.params = model.params()
        self.param = param
        self.cost = (param.cost_ce, param.cost_dice, param.cost_mse)
        self.cdt = torch.bfloat16 if param.compute_dtype == "bfloat16" else torch.float32
        self.any_shift = any_shift
        self.collapse_k = collapse_k
        self.has_subjects = has_subjects
        self.sgd = SGDConfig()

    def _sync_time(self, timings) -> float:
        if timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @torch.no_grad()
    def synthesize(self, image: torch.Tensor, label: torch.Tensor, is_template: bool,
                   rng: np.random.Generator, *, plain: bool = False):
        """One item, image (D, H, W, C) and label (D, H, W) on the device:
        contrast simulation then the augmentation, with the draws of
        ``rng`` (simulation first).  Returns f32 (image', label')."""
        opt = self.param.options
        t1w, lab = image[..., 0].float(), label.float()
        if self.param.is_label and (is_template or not self.has_subjects):
            x = simulate_modality_template(t1w, lab, self.n_classes,
                                           draw_simulation(rng, self.n_classes))
        else:
            x = simulate_modality_subject(t1w, draw_simulation(rng, None))
        draws = draw_augmentation(opt, tuple(lab.shape), rng, is_label=self.param.is_label,
                                  device=self.device)
        return visual_perception_augmentation(x[..., None], lab, draws, opt,
                                              self.param.is_label, plain=plain)

    def grads(self, images, labels, need_shift=None, *, is_template=None, seeds=None,
              plain: bool = False, timings=None):
        """(grads, metrics, loss): the gradients summed over the items and
        divided by ``batch_size``, keyed like ``model.params()``.
        ``plain=True`` runs the kernels' twins, the synthesis's included."""
        images = torch.as_tensor(images).to(self.device)
        labels = torch.as_tensor(labels).to(self.device)
        b = images.shape[0]
        shift = np.zeros(b, bool) if need_shift is None else np.asarray(
            torch.as_tensor(need_shift).cpu(), bool)
        tmpl = np.ones(b, bool) if is_template is None else np.asarray(
            torch.as_tensor(is_template).cpu(), bool)
        names = list(self.params)
        leaves = [self.params[k].detach().requires_grad_() for k in names]
        leaf_dict = dict(zip(names, leaves))
        acc = None
        metrics = torch.zeros(4, dtype=torch.float32, device=self.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        syn_s = fwd_s = bwd_s = 0.0
        for i in range(b):
            collapse = self.collapse_k if self.any_shift and shift[i] else 0
            t0 = self._sync_time(timings)
            img, lab = images[i], labels[i]
            if seeds is not None:
                img, lab = self.synthesize(img, lab, bool(tmpl[i]), item_rng(*seeds[i]),
                                           plain=plain)
            t1 = self._sync_time(timings)
            outs = forward_train(self.spec, leaf_dict, img[None], compute_dtype=self.cdt,
                                 plain=plain)
            loss, lvl0 = deep_supervision_loss(outs, lab[None].long(), self.n_classes,
                                               collapse, *self.cost)
            t2 = self._sync_time(timings)
            g = torch.autograd.grad(loss, leaves, materialize_grads=True)
            del outs
            t3 = self._sync_time(timings)
            syn_s, fwd_s, bwd_s = syn_s + t1 - t0, fwd_s + t2 - t1, bwd_s + t3 - t2
            acc = list(g) if acc is None else [a.add_(x) for a, x in zip(acc, g)]
            record = 0.0 if self.has_subjects and tmpl[i] else 1.0
            metrics += torch.cat([torch.stack(lvl0).detach(), metrics.new_ones(1)]) * record
            loss_sum += loss.detach()
        if timings is not None:
            timings.update(synth_s=syn_s, forward_s=fwd_s, backward_s=bwd_s)
        grads = {k: a / self.param.batch_size for k, a in zip(names, acc)}
        return grads, metrics, loss_sum

    def __call__(self, opt_state, images, labels, need_shift=None, lr=None, *,
                 is_template=None, seeds=None, timings=None):
        grads, metrics, loss = self.grads(images, labels, need_shift, is_template=is_template,
                                          seeds=seeds, timings=timings)
        t0 = self._sync_time(timings)
        lr = self.param.learning_rate if lr is None else lr
        opt_state = sgd_step(self.params, grads, opt_state, lr, self.sgd)
        if timings is not None:
            timings["optimizer_s"] = self._sync_time(timings) - t0
        return opt_state, metrics, loss


def build_train_step(model: UNet3d, param: TrainParam, *, any_shift: bool = False,
                     collapse_k: int = 1, has_subjects: bool = False, device=None):
    """(train_step, valid_step) for ``model`` on ``device`` (default: the
    card; the CPU only when asked for).  ``train_step`` is a
    ``TrainStep``; ``valid_step(images (N, D, H, W, C), labels (N, D, H,
    W))`` returns the f32 [ce, dice, mse] of the inference forward's
    level-0 logits (train.py:223-226 of the JAX package)."""
    step = TrainStep(model, param, any_shift=any_shift, collapse_k=collapse_k,
                     has_subjects=has_subjects, device=device)

    @torch.no_grad()
    def valid_step(images, labels):
        images = torch.as_tensor(images).to(step.device)
        labels = torch.as_tensor(labels).to(step.device)
        outs = forward_fused(step.spec, step.params, images, compute_dtype=step.cdt,
                             level0_only=True)
        return torch.stack(calc_losses(outs[0], labels.long(), step.n_classes))

    return step, valid_step


class TrainEngine:
    """start() / run_epoch() / run() / stop() around ``TrainStep``."""

    def __init__(self, model: UNet3d, param: TrainParam, model_path: str = "",
                 save_model_during_training: bool = True, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.param = param
        self.model_path = model_path
        self.save_model_during_training = save_model_during_training
        self.aborted = False
        self.paused = False  # cooperative pause flag (train.hpp:99)
        self.error_msg = ""
        self.reading_status = self.training_status = self.validation_status = "idle"
        self.cur_epoch = 0
        self.dataset: TrainingDataset | None = None
        self.opt_state = None
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._batch_cache: tuple | None = None
        self._test_data: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._step = self._valid = None
        # the sample stream's generator, replayed from the seed only on a
        # resume or an out-of-order request
        self._sample_rng: np.random.Generator | None = None
        self._rng_pos = -1
        self._prefetch: tuple | None = None
        self._reader: ThreadPoolExecutor | None = None
        self._slot_ready: list[bool] = []  # per-slot load state of the batch being read

    # ------------------------------------------------------------------ setup

    def start(self) -> None:
        if not self.param.image_file_name:
            self.error_msg = "please specify the training data"
            self.aborted = True
            return
        self.reading_status = "scanning labels"
        self.dataset = TrainingDataset.scan(self.param.image_file_name,
                                            self.param.label_file_name, self.model.out_count)
        self.opt_state = init_opt_state(self.model.params())
        self._maybe_load_optimizer()
        # resume epoch from the error history (train.cpp:1005)
        self.cur_epoch = (len(self.model.testing_errors) // 3) % self.param.epoch
        self._load_test_volumes()
        self._step, self._valid = build_train_step(
            self.model, self.param, any_shift=any(self.dataset.need_shift),
            collapse_k=int(self.dataset.max_template_label + 1),
            has_subjects=self.dataset.has_subject_data, device=self.device)
        self.training_status = "training"

    def _maybe_load_optimizer(self) -> None:
        """The ``.opt`` file beside the model: the JAX package's format, an
        npz of ``momentum/<name>`` arrays in its layouts and ``step``."""
        opt_path = self.model_path + ".opt" if self.model_path else ""
        if opt_path and os.path.exists(opt_path):
            data = np.load(opt_path)
            state = from_jax_opt_state(self.model.spec, {
                "momentum": {k[len("momentum/"):]: v for k, v in data.items()
                             if k.startswith("momentum/")},
                "step": data["step"]})
            for k, v in state["momentum"].items():
                self.opt_state["momentum"][k].copy_(v)
            self.opt_state["step"] = state["step"]

    def _save_optimizer(self) -> None:
        if not self.model_path:
            return
        state = to_jax_opt_state(self.model.spec, self.opt_state)
        arrs = {f"momentum/{k}": v for k, v in state["momentum"].items()}
        arrs["step"] = state["step"]
        np.savez(self.model_path + ".opt", **arrs)
        os.replace(self.model_path + ".opt.npz", self.model_path + ".opt")

    def _load_test_volumes(self) -> None:
        self._test_data = []
        for i in self.dataset.test_indices:
            self.reading_status = f"reading {os.path.basename(self.dataset.images[i])}"
            img, lab = self._load_item(i)
            if self.model.out_count == 1:
                mx = lab.max()
                if mx > 0:
                    lab = lab / mx
            self._test_data.append((torch.from_numpy(img[None, ..., None]).to(self.device),
                                    torch.from_numpy(lab[None]).to(self.device)))

    def _load_item(self, read_id: int) -> tuple[np.ndarray, np.ndarray]:
        """Load and resample one pair; templates stay cached
        (train.cpp:404-432)."""
        if read_id in self._cache:
            return self._cache[read_id]
        img, lab = load_pair_on_model_grid(self.dataset.images[read_id],
                                           self.dataset.labels[read_id], self.model.dim,
                                           self.model.voxel_size, device=self.device)
        if not self.param.is_label:
            mx = lab.max()
            if mx > 0:
                lab = lab / mx
        if self.dataset.need_shift[read_id]:
            lab = shift_subject_label(img, lab, self.dataset.max_template_label)
        pair = (img, lab)
        if self.dataset.is_template[read_id]:
            self._cache[read_id] = pair
        return pair

    # ------------------------------------------------------------- epoch loop

    def _epoch_draws(self, epoch: int) -> list[tuple[int, int]]:
        """(seed_id, read_id) picks for one epoch (train.cpp:391-399)."""
        ds = self.dataset
        b = self.param.batch_size
        start = epoch * b
        if self._sample_rng is None or self._rng_pos != start:
            self._sample_rng = np.random.default_rng(self.param.seed)
            for seed_id in range(start):
                ds.sample_index(self._sample_rng, seed_id % b, b)
            self._rng_pos = start
        ids = [(seed_id, ds.sample_index(self._sample_rng, seed_id % b, b))
               for seed_id in range(start, start + b)]
        self._rng_pos = start + b
        return ids

    def _assemble_batch(self, epoch: int):
        ds = self.dataset
        ids = self._epoch_draws(epoch)
        seeds = [(self.param.seed, seed_id) for seed_id, _ in ids]
        # one-template training repeats the same volumes every epoch: keep
        # the batch on the device and only draw new items from it
        ids_tuple = tuple(read_id for _, read_id in ids)
        if self._batch_cache is not None and self._batch_cache[0] == ids_tuple:
            return (*self._batch_cache[1], seeds)
        images, labels = [], []
        self._slot_ready = [False] * len(ids)
        for slot, (_, read_id) in enumerate(ids):
            self.reading_status = f"reading {os.path.basename(ds.images[read_id])}"
            img, lab = self._load_item(read_id)
            images.append(img[..., None])
            labels.append(lab)
            self._slot_ready[slot] = True
        batch = (torch.from_numpy(np.stack(images)).to(self.device),
                 torch.from_numpy(np.stack(labels)).to(self.device),
                 np.asarray([ds.is_template[r] for r in ids_tuple]),
                 np.asarray([ds.need_shift[r] for r in ids_tuple]))
        # cache only an all-template batch (no subject volume stays pinned)
        self._batch_cache = (ids_tuple, batch) if all(ds.is_template[r] for r in ids_tuple) \
            else None
        return (*batch, seeds)

    def _get_batch(self, epoch: int):
        """The reader thread's batch if it built this epoch's, else one
        assembled now (train.cpp:259-444)."""
        if self._prefetch is not None:
            pf_epoch, fut = self._prefetch
            self._prefetch = None
            if pf_epoch == epoch:
                return fut.result()
            fut.result()  # drain an out-of-order prefetch
        return self._assemble_batch(epoch)

    def _submit_prefetch(self, epoch: int) -> None:
        if epoch >= self.param.epoch:
            return
        if self._reader is None:
            self._reader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="unet-reader")
        self._prefetch = (epoch, self._reader.submit(self._assemble_batch, epoch))

    def run_epoch(self) -> dict:
        e = self.cur_epoch
        lr = poly_lr(self.param.learning_rate, e, self.param.epoch)
        images, labels, tmpl, shift, seeds = self._get_batch(e)
        self.training_status = "training"
        self.opt_state, metrics, _ = self._step(self.opt_state, images, labels, shift, lr,
                                                is_template=tmpl, seeds=seeds)
        # validation on the held-out templates (train.cpp:826-896), while
        # the reader assembles the next epoch's batch
        self.validation_status = "validating"
        vals = [self._valid(img, lab) for img, lab in self._test_data]
        self.cur_epoch += 1
        self._submit_prefetch(self.cur_epoch)
        metrics = metrics.cpu().numpy()
        if metrics[3] > 0:
            errs = (metrics[:3] / metrics[3]).tolist()
            self.model.training_errors.extend(round(float(v), 6) for v in errs)
        if vals:
            acc = np.zeros(3)
            for v in vals:
                acc += v.cpu().numpy()
            acc /= len(vals)
            self.model.testing_errors.extend(round(float(v), 6) for v in acc)
        # autosave every 100 epochs (train.cpp:780-788)
        if self.save_model_during_training and self.model_path and self.cur_epoch % 100 == 0:
            self.training_status = "saving model"
            save_model(self.model_path, self.model)
            self._save_optimizer()
        return {"epoch": e, "lr": lr, "train": self.model.training_errors[-3:],
                "test": self.model.testing_errors[-3:]}

    def run(self, chart: bool = True) -> None:
        """Blocking loop to ``param.epoch`` (train.cpp:913-919).  A failure
        (an unreadable file, a device error) sets ``error_msg`` and
        ``aborted`` instead of escaping (train.cpp:709-721, 791-802)."""
        start = time.time()
        start_epoch = self.cur_epoch
        if chart:
            print("1" + " " * 50 + "0.1" + " " * 47 + "0.01")
        try:
            while self.cur_epoch < self.param.epoch and not self.aborted:
                while self.paused and not self.aborted:
                    time.sleep(0.1)  # cooperative pause (train.hpp:99)
                if self.aborted:
                    break
                info = self.run_epoch()
                if chart:
                    self._print_chart_row(info, start, start_epoch)
        except Exception as exc:  # noqa: BLE001
            self.error_msg = self.error_msg or f"{type(exc).__name__}: {exc}"
            self.aborted = True
        finally:
            self._close_reader()

    def _print_chart_row(self, info, start_time, start_epoch) -> None:
        """Log-scale ASCII error chart (train.cpp:853-888)."""
        e = info["epoch"]
        if e % 100 == 0:
            out = list("|-------------------------|--------------------------|"
                       "-------------------------|-------------------------|")
            s = f"lr:{info['lr']:.6f}"
            done = self.cur_epoch - start_epoch
            if done > 0:
                rem = (time.time() - start_time) * (self.param.epoch - self.cur_epoch) / done
                s += f",{int(rem // 3600)}h{int(rem % 3600 // 60)}m"
            out[1: 1 + len(s)] = s
            print("".join(out))
        out = list("|                         |                          |"
                   "                         |                         |")

        def put(val, ch):
            if val <= 0:
                return
            pos = int((-np.log10(max(val, 1e-10))) * (len(out) - 1) / 2.0)
            out[int(np.clip(pos, 0, len(out) - 1))] = ch

        for v, ch in zip(info["train"], "cdm"):
            put(v, ch)
        for v, ch in zip(info["test"], "CDM"):
            put(v, ch)
        print("".join(out) + f" {e}")

    def pause(self) -> None:
        """Cooperative pause: run() idles at the next epoch boundary
        (train.cpp:574)."""
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def _close_reader(self) -> None:
        if self._reader is not None:
            self._reader.shutdown(wait=True, cancel_futures=True)
            self._reader = None
            self._prefetch = None

    def stop(self) -> None:
        self.aborted = True
        self.paused = False
        self._close_reader()

    def get_status(self) -> str:
        state = "paused" if self.paused else self.training_status
        # per-slot occupancy, '-' loaded / '_' pending (train.cpp:488-499)
        slots = "".join("-" if r else "_" for r in self._slot_ready)
        return (f"epoch {self.cur_epoch}/{self.param.epoch} "
                f"[{slots}] {self.reading_status}|{state}|{self.validation_status}")
