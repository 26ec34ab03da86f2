"""Web UI of the port, the functional analog of the reference's Qt GUI
(the counterpart of unet_studio_tpu/ui/server.py, with the same
endpoints, JSON keys and status codes, so ``app.html`` works against
either server).

* Evaluate: load a model (zoo or path) + image, run inference, browse the
  three orthogonal slice views with label overlay and contrast control,
  save any of the 4 output types.
* Train: point at a BIDS folder, set hyperparameters, start/stop a
  training run (a background thread, one rank on the server's device),
  watch the live error chart, preview the augmented sample stream with a
  seed slider.
* Console: the captured log ring buffer (console.cpp analog); its command
  line runs the port's CLI, ``--data_parallel n`` for several cards.

Run: ``python -m unet_studio_tpu_torch.ui [--device cuda|cpu]`` (or
``unet-studio-tpu-torch-ui``).  It runs on the card unless ``--device
cpu`` is given.  No external dependencies beyond the port's: stdlib
http.server + a minimal PNG encoder.
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from contextlib import redirect_stderr, redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.assets import find_asset_root, scan_templates, zoo_models
from ..utils.device import resolve_device
from .png import render_slice

# leading words of a console command line that name the program: the
# port's, and the JAX package's, so a command copied from its docs runs
PROGRAM_NAMES = ("unet-studio-tpu-torch", "unet_studio_tpu_torch", "unet-studio-tpu",
                 "unet_studio_tpu")


class _Log:
    """stdout/stderr capture ring buffer (console.h:10-33 analog)."""

    def __init__(self, limit: int = 2000):
        self.lines: list[str] = []
        self.limit = limit
        self._lock = threading.Lock()

    def write(self, text: str):
        with self._lock:
            for ln in text.split("\n"):
                if ln.strip():
                    self.lines.append(ln)
            del self.lines[: -self.limit]
        return len(text)

    def flush(self):
        pass

    def tail(self, n: int = 200):
        with self._lock:
            return self.lines[-n:]


class AppState:
    """The UI's state: the loaded model, the evaluated cases, the training
    run, the persisted settings.  Every model, engine and kernel call runs
    on ``device`` (default: the card; the CPU only when asked for)."""

    def __init__(self, asset_root: str | None = None, device=None):
        from ..config.session import Settings

        self.device = resolve_device(device)
        self.log = _Log()
        self.asset_root = find_asset_root(asset_root)
        # persisted per-user defaults (the QSettings analog,
        # optiontablewidget.cpp:437-441 + mainwindow MRU): option
        # overrides, MRU dirs, last network.  Path overridable for tests.
        self.settings = Settings(os.environ.get("UNET_TPU_SETTINGS"))
        self.model = None
        self.model_path = ""
        self.eval_engine = None
        self.case = None  # current EvalCase
        self.cases = []  # per-case list (evaluate_list analog)
        self.cur_index = -1
        self.train_engine = None
        self.train_thread: threading.Thread | None = None
        self.atlas = None  # AtlasParcellation (evaluate-tab selection)

    def _push_mru(self, key: str, value: str, limit: int = 10) -> None:
        """Most-recently-used list in the persisted settings (the
        reference's working-dir MRU, mainwindow.cpp)."""
        mru = [v for v in self.settings.value(key, []) if v != value]
        self.settings.set(key, [value] + mru[: limit - 1])

    def get_settings(self) -> dict:
        return {
            "last_network": self.settings.value("last_network", ""),
            "mru_model_dirs": self.settings.value("mru_model_dirs", []),
            "mru_source_dirs": self.settings.value("mru_source_dirs", []),
            "mru_bids": self.settings.value("mru_bids", []),
            "option_overrides": self.settings.value("option_overrides", {}),
        }

    def set_option_overrides(self, overrides: dict) -> dict:
        """Persist per-user augmentation-option overrides; /api/options
        reports them merged over the defaults (the QSettings
        settings.value(id, default) behavior, optiontablewidget.cpp:437-441)."""
        cur = dict(self.settings.value("option_overrides", {}))
        for k, v in overrides.items():
            if v is None:
                cur.pop(k, None)
            else:
                cur[k] = float(v)
        self.settings.set("option_overrides", cur)
        self.settings.save()
        return {"option_overrides": cur}

    # ---------------- evaluate ----------------

    def load_model(self, path: str) -> dict:
        from ..models.serialize import load_model

        self.model = load_model(path, device=self.device)
        self.model_path = path
        self.eval_engine = None
        self.settings.set("last_network", path)
        self._push_mru("mru_model_dirs", os.path.dirname(os.path.abspath(path)))
        self.settings.save()
        return {
            "path": path,
            "in_count": self.model.in_count,
            "out_count": self.model.out_count,
            "dim": list(self.model.dim),
            "voxel_size": [float(v) for v in self.model.voxel_size],
            "info": self.model.get_info(),
        }

    def evaluate(self, sources) -> dict:
        """Evaluate one or many volumes (the reference's checked
        evaluate_list, mainwindow_evaluation.cpp:292-337).  ``sources``:
        a path, or a list / newline-separated string of paths.  All cases
        run through the engine's 3-stage pipeline; the first successful
        case becomes current."""
        from ..engine.evaluate import EvaluateEngine

        if self.model is None:
            raise RuntimeError("load a model first")
        if isinstance(sources, str):
            sources = [s.strip() for s in sources.splitlines() if s.strip()]
        if not sources:
            raise RuntimeError("no source volumes given")
        if self.eval_engine is None:
            self.eval_engine = EvaluateEngine(self.model, device=self.device)
        self.eval_engine.error_msg = ""
        self._push_mru(
            "mru_source_dirs", os.path.dirname(os.path.abspath(sources[0]))
        )
        self.settings.save()
        self.cases = list(self.eval_engine.run(sources))
        self.case = None
        self.cur_index = -1
        rows = []
        for i, case in enumerate(self.cases):
            if not case.error_msg and self.case is None:
                self.case = case
                self.cur_index = i
            rows.append(
                {
                    "path": case.path,
                    "dims": list(case.image_dim) if case.label is not None else [],
                    "error": case.error_msg,
                }
            )
        if self.case is None:
            raise RuntimeError(self.cases[0].error_msg or "evaluation failed")
        return {
            "dims": list(self.case.image_dim),
            "path": self.case.path,
            "cases": rows,
            "current": self.cur_index,
        }

    def select_case(self, index: int) -> dict:
        """Switch the current case (evaluate_list row change)."""
        if not (0 <= index < len(self.cases)):
            raise RuntimeError(f"no case {index}")
        case = self.cases[index]
        if case.error_msg:
            raise RuntimeError(case.error_msg)
        self.case = case
        self.cur_index = index
        return {"dims": list(case.image_dim), "path": case.path, "current": index}

    def _native_input(self, case) -> np.ndarray:
        from ..io.nifti import canonicalize_lps, read_nifti

        vol = canonicalize_lps(read_nifti(case.path)).data.astype(np.float32)
        if vol.ndim == 4:
            vol = vol[0]
        return vol / max(vol.max(), 1e-9)

    # the reference evaluate tab's 4 output views
    # (mainwindow_evaluation.cpp:292-352): label overlay on the input,
    # skull-stripped image, foreground mask, per-channel probability
    EVAL_VIEWS = ("input", "fg", "skull_strip", "mask", "prob")

    def eval_slice(
        self,
        axis: int,
        index: int,
        overlay: int,
        view: str,
        vmin: float = 0.0,
        vmax: float = 1.0,
        channel: int = 0,
    ) -> bytes:
        case = self.case
        if case is None:
            raise RuntimeError("no evaluated case")
        if view == "fg":
            vol = case.fg_prob
        elif view == "input":
            vol = self._native_input(case)
        elif view == "skull_strip":
            vol = self._native_input(case) * case.fg_prob
        elif view == "mask":
            vol = (
                case.mask if case.mask is not None else case.fg_prob > 0.5
            ).astype(np.float32)
        elif view == "prob":
            prob = case.label_prob  # (C,D,H,W), fetched lazily
            if prob is None:
                raise RuntimeError("no probability volume")
            vol = prob[int(np.clip(channel, 0, prob.shape[0] - 1))]
        else:
            # strict: an unknown view is a client bug, not a silent fg view
            raise RuntimeError(
                f"unknown view {view!r}; expected one of {self.EVAL_VIEWS}"
            )
        lab = case.label if overlay else None
        index = int(np.clip(index, 0, vol.shape[axis] - 1))
        sl = np.take(vol, index, axis=axis)
        lsl = None if lab is None else np.take(lab, index, axis=axis)
        return render_slice(sl, lsl, vmin=vmin, vmax=vmax)

    def eval_action(self, cmd: str, param1: float, param2: float) -> dict:
        """Interactive post-processing action on the evaluated case
        (postproc.txt ids; mainwindow_evaluation button wiring)."""
        if self.case is None or self.eval_engine is None:
            raise RuntimeError("no evaluated case")
        self.eval_engine.proc_action(self.case, cmd, param1, param2)
        return {"ok": True, "cmd": cmd}

    def load_atlas(self, template: str, atlas: str) -> dict:
        """Template/atlas selection on the evaluate tab
        (mainwindow.cpp:66-75; mainwindow_evaluation.cpp:100-121): loads
        the tissue template + atlas, builds/caches the corrected atlas,
        reports the parcellation region count."""
        from ..engine.atlas import AtlasParcellation

        parc = AtlasParcellation(device=self.device)
        if not parc.load_template(template) or not parc.load_atlas(atlas):
            raise RuntimeError(parc.error_msg or "atlas load failed")
        self.atlas = parc
        return {"regions": parc.atlas_region_count}

    def save_result(self, out_path: str, output_type: int) -> dict:
        if self.case is None or self.eval_engine is None:
            raise RuntimeError("no evaluated case")
        ok = self.eval_engine.save_case(self.case, out_path, output_type)
        if not ok:
            raise RuntimeError("save failed")
        return {"saved": out_path}

    def save_all(self, out_path: str, output_type: int) -> dict:
        """Batch save: the current case goes to ``out_path``; every other
        evaluated case's name is derived by applying the same
        source->output rewrite (the reference's "Save others?" loop with
        tipl::match_files, mainwindow_evaluation.cpp:384-410)."""
        from ..utils.match import match_files

        if self.case is None or self.eval_engine is None:
            raise RuntimeError("no evaluated case")
        if not self.eval_engine.save_case(self.case, out_path, output_type):
            raise RuntimeError("save failed")
        saved = [out_path]
        errors = []
        for i, case in enumerate(self.cases):
            if i == self.cur_index:
                continue
            if case.error_msg or case.label is None:
                errors.append(f"{case.path}: {case.error_msg or 'not evaluated'}")
                continue
            result = match_files(self.case.path, out_path, case.path)
            if result is None:
                errors.append(f"cannot match file name for {case.path}")
                continue
            if self.eval_engine.save_case(case, result, output_type):
                saved.append(result)
            else:
                errors.append(f"cannot save {result}")
        return {"saved": saved, "errors": errors}

    # ---------------- train ----------------

    def start_training(self, cfg: dict) -> dict:
        """Train in a background thread as one rank on the server's device
        (``mesh=None``): the port's data axis is one process per rank, so
        several cards train through the console's ``--data_parallel n``."""
        from ..data.bids import get_bids_pairs
        from ..engine.train import TrainEngine, TrainParam
        from ..io.nifti import read_nifti
        from ..models.dsl import default_architecture
        from ..models.serialize import load_model
        from ..models.unet3d import UNet3d, round_up_size
        from ..ops.augment import AugOptions

        if self.train_engine is not None and not self.train_engine.aborted:
            raise RuntimeError("training already running")
        images, labels = get_bids_pairs(cfg["bids"])
        model_path = cfg.get("model", "trained_model.nz")
        if not model_path.endswith("nz"):
            model_path += ".nz"
        if os.path.exists(model_path):
            model = load_model(model_path, device=self.device)
        else:
            lbl = read_nifti(labels[0])
            img = read_nifti(images[0])
            out_count = int(np.max(lbl.data)) + 1
            model = UNet3d.create(1, out_count, default_architecture(out_count),
                                  device=self.device)
            model.dim = round_up_size(img.shape_xyz, 32)
            model.voxel_size = np.asarray(img.voxel_size, np.float32)
        # persisted per-user overrides are the baseline; the request's
        # explicit options win (the QSettings-backed option tree)
        opt_values = dict(self.settings.value("option_overrides", {}))
        opt_values.update(cfg.get("options", {}))
        param = TrainParam(
            image_file_name=images,
            label_file_name=labels,
            batch_size=int(cfg.get("batch_size", 8)),
            epoch=int(cfg.get("epoch", 10000)),
            learning_rate=float(cfg.get("learning_rate", 1e-3)),
            seed=int(cfg.get("seed", 0)),
            options=AugOptions.from_dict(opt_values),
        )
        self._push_mru("mru_bids", cfg["bids"])
        self.settings.save()
        engine = TrainEngine(model, param, model_path=model_path, device=self.device)
        self.train_engine = engine

        def run():
            try:
                with redirect_stdout(self.log), redirect_stderr(self.log):
                    engine.start()
                    if not engine.error_msg:
                        engine.run(chart=True)
            except Exception:  # noqa: BLE001
                self.log.write(traceback.format_exc())
                engine.error_msg = engine.error_msg or "training crashed (see console)"

        self.train_thread = threading.Thread(target=run, daemon=True)
        self.train_thread.start()
        return {"pairs": len(images), "model": model_path, "devices": 1}

    @staticmethod
    def _decimate_errors(errors: list, max_epochs: int = 1000):
        """Full-history error curve, decimated (NOT truncated) to at most
        ``max_epochs`` points: the reference plots the entire history
        (mainwindow_training.cpp:405-510); a 10000-epoch run must not lose
        its first 90%.  Errors come in (ce, dice, mse) triplets per epoch;
        decimation picks whole epochs, evenly spaced, always keeping the
        first and the last.  Returns (flat_triplets, epoch_indices)."""
        n = len(errors) // 3
        if n <= max_epochs:
            return errors[: n * 3], list(range(n))
        idx = np.unique(
            np.round(np.linspace(0, n - 1, max_epochs)).astype(int)
        )
        flat = []
        for i in idx:
            flat.extend(errors[3 * i : 3 * i + 3])
        return flat, idx.tolist()

    def train_status(self) -> dict:
        e = self.train_engine
        if e is None:
            return {"running": False}
        tr, tr_epochs = self._decimate_errors(e.model.training_errors)
        te, te_epochs = self._decimate_errors(e.model.testing_errors)
        return {
            "running": not e.aborted,
            "epoch": e.cur_epoch,
            "total_epochs": e.param.epoch,
            "status": e.get_status(),
            "error_msg": e.error_msg,
            "training_errors": tr,
            "testing_errors": te,
            "training_error_epochs": tr_epochs,
            "testing_error_epochs": te_epochs,
        }

    def stop_training(self) -> dict:
        if self.train_engine is not None:
            self.train_engine.stop()
        return {"stopped": True}

    def pause_training(self, resume: bool = False) -> dict:
        """Cooperative pause/resume (train.hpp:99 pause flag)."""
        e = self.train_engine
        if e is None:
            raise RuntimeError("no training run")
        e.resume() if resume else e.pause()
        return {"paused": e.paused}

    def new_network(self, cfg: dict) -> dict:
        """New-network dialog analog (mainwindow_training.cpp:146-182):
        create a model from an architecture string + channel counts and
        save it where training will pick it up."""
        from ..models.dsl import default_architecture
        from ..models.serialize import save_model
        from ..models.unet3d import UNet3d

        out_count = int(cfg.get("out_count", 2))
        arch = cfg.get("architecture") or default_architecture(out_count)
        model = UNet3d.create(int(cfg.get("in_count", 1)), out_count, arch, device=self.device)
        if cfg.get("dim"):
            model.dim = tuple(int(v) for v in cfg["dim"])
        if cfg.get("voxel_size"):
            model.voxel_size = np.asarray(cfg["voxel_size"], np.float32)
        path = cfg.get("model", "new_model.nz")
        if not path.endswith("nz"):
            path += ".nz"
        save_model(path, model, sloped=False)
        return {
            "model": path,
            "in_count": model.in_count,
            "out_count": model.out_count,
            "architecture": model.architecture,
        }

    def label_census(self, bids: str) -> dict:
        """Scan the matched pairs' labels: per-pair max label + template
        flag (the label census shown by the training tab,
        mainwindow_training.cpp:253-255)."""
        from ..data.bids import get_bids_pairs, read_label_info

        images, labels = get_bids_pairs(bids)
        rows = []
        max_label = 0
        for img, lbl in zip(images, labels):
            try:
                is_template, mx = read_label_info(lbl)
            except Exception as e:  # noqa: BLE001
                rows.append({"image": img, "label": lbl, "error": str(e)})
                continue
            max_label = max(max_label, mx)
            rows.append(
                {
                    "image": os.path.basename(img),
                    "label": os.path.basename(lbl),
                    "max_label": mx,
                    "template": is_template,
                }
            )
        return {"pairs": rows, "max_label": max_label,
                "suggested_out_count": max_label + 1}

    def reorder_channels(self, order: list[int]) -> dict:
        """Output-channel reorder (mainwindow_training.cpp:721-779) on the
        loaded model via models/surgery.py."""
        from ..models.surgery import reorder_output_channels

        if self.model is None:
            raise RuntimeError("load a model first")
        self.model = reorder_output_channels(self.model, [int(v) for v in order])
        self.eval_engine = None
        return {"out_count": self.model.out_count}

    def console_run(self, cmd: str) -> dict:
        """Embedded command line: re-parse a CLI argument string and run the
        port's CLI on a worker thread with output captured to the console
        ring (console.cpp:139-154)."""
        import shlex

        from .. import cli

        argv = shlex.split(cmd)
        if argv and argv[0] in PROGRAM_NAMES:
            argv = argv[1:]

        def run():
            with redirect_stdout(self.log), redirect_stderr(self.log):
                try:
                    rc = cli.main(argv)
                    self.log.write(f"[command exited with code {rc}]\n")
                except SystemExit as e:
                    self.log.write(f"[command exited with code {e.code}]\n")
                except Exception:  # noqa: BLE001
                    self.log.write(traceback.format_exc())

        threading.Thread(target=run, daemon=True).start()
        return {"started": cmd}

    def aug_preview(self, seed: int, axis: int) -> bytes:
        """Re-run simulate_modality + augmentation with a chosen seed on the
        first training pair (mainwindow_training.cpp:571-625 analog), on
        the server's device: the draws of ``item_rng(param.seed, seed)``,
        simulation first, as the train step draws sample ``seed``."""
        import torch

        from ..engine.train import _labels_u8, item_rng
        from ..ops.augment import draw_augmentation, visual_perception_augmentation
        from ..ops.simulate import draw_simulation, simulate_modality_template

        e = self.train_engine
        if e is None or e.dataset is None:
            raise RuntimeError("start (or configure) training first")
        img, lab = e._load_item(e.dataset.template_indices[0] if e.dataset.template_indices else 0)
        p, n_classes = e.param, e.model.out_count
        rng = item_rng(p.seed, seed)
        image = torch.from_numpy(img).to(self.device)
        # integer labels reach the warp as uint8, as TrainEngine hands them over
        label = torch.from_numpy(_labels_u8(lab) if p.is_label else lab).to(self.device)
        with torch.no_grad():
            sim = simulate_modality_template(image, label, n_classes,
                                             draw_simulation(rng, n_classes))
            draws = draw_augmentation(p.options, tuple(label.shape), rng, is_label=p.is_label,
                                      device=self.device)
            aug_img, aug_lab = visual_perception_augmentation(sim[..., None], label, draws,
                                                              p.options, p.is_label)
        vol = aug_img[..., 0].cpu().numpy()
        lvol = aug_lab.cpu().numpy()
        idx = vol.shape[axis] // 2
        return render_slice(
            np.take(vol, idx, axis=axis), np.take(lvol, idx, axis=axis)
        )


def _html() -> str:
    path = os.path.join(os.path.dirname(__file__), "app.html")
    with open(path) as f:
        return f.read()


def make_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            try:
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                if u.path in ("/", "/index.html"):
                    self._send(200, _html().encode(), "text/html")
                elif u.path == "/api/assets":
                    root = state.asset_root
                    seg, atlases = scan_templates(root)
                    self._json(
                        {
                            "zoo": zoo_models(root),
                            "templates": seg,
                            "atlases": atlases,
                        }
                    )
                elif u.path == "/api/eval/slice":
                    png = state.eval_slice(
                        int(q.get("axis", 0)),
                        int(q.get("index", 0)),
                        int(q.get("overlay", 1)),
                        q.get("view", "input"),
                        float(q.get("vmin", 0.0)),
                        float(q.get("vmax", 1.0)),
                        int(q.get("channel", 0)),
                    )
                    self._send(200, png, "image/png")
                elif u.path == "/api/options":
                    from ..config.options import OPTION_TABLE, POSTPROC_TABLE

                    overrides = state.settings.value("option_overrides", {})

                    def row(o):
                        return {
                            "category": o.category, "title": o.title,
                            "id": o.id, "kind": o.kind,
                            # persisted per-user value wins over the table
                            # default (QSettings analog)
                            "default": overrides.get(o.id, o.default),
                            "min": o.minimum, "max": o.maximum,
                            "step": o.step, "decimals": o.decimals,
                            "hint": o.hint,
                        }

                    self._json(
                        {
                            "options": [row(o) for o in OPTION_TABLE],
                            "postproc": [row(o) for o in POSTPROC_TABLE],
                        }
                    )
                elif u.path == "/api/settings":
                    self._json(state.get_settings())
                elif u.path == "/api/train/label_census":
                    self._json(state.label_census(q["bids"]))
                elif u.path == "/api/train/status":
                    self._json(state.train_status())
                elif u.path == "/api/aug/preview":
                    png = state.aug_preview(int(q.get("seed", 0)), int(q.get("axis", 0)))
                    self._send(200, png, "image/png")
                elif u.path == "/api/console":
                    self._json({"lines": state.log.tail(int(q.get("n", 200)))})
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                self._json({"error": str(e)}, 500)

        def _origin_ok(self) -> bool:
            """CSRF guard for state-changing endpoints: although the server
            binds localhost, any webpage in the user's browser can fire a
            cross-origin POST (e.g. re-invoking the CLI via
            /api/console/run with --save_session to an arbitrary path).
            Reject any Origin that is not this server itself; requests
            without an Origin header (curl, tests, same-origin fetches in
            older browsers) are allowed."""
            origin = self.headers.get("Origin")
            if not origin:
                return True
            host = urlparse(origin).hostname
            return host in ("127.0.0.1", "localhost", "::1")

        def do_POST(self):
            try:
                if not self._origin_ok():
                    self._json({"error": "cross-origin request rejected"}, 403)
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                u = urlparse(self.path)
                if u.path == "/api/model/load":
                    self._json(state.load_model(body["path"]))
                elif u.path == "/api/eval/run":
                    self._json(
                        state.evaluate(body.get("sources") or body["source"])
                    )
                elif u.path == "/api/eval/select":
                    self._json(state.select_case(int(body["index"])))
                elif u.path == "/api/eval/save":
                    self._json(
                        state.save_result(body["path"], int(body.get("output_type", 0)))
                    )
                elif u.path == "/api/eval/save_all":
                    self._json(
                        state.save_all(body["path"], int(body.get("output_type", 0)))
                    )
                elif u.path == "/api/train/start":
                    self._json(state.start_training(body))
                elif u.path == "/api/train/stop":
                    self._json(state.stop_training())
                elif u.path == "/api/train/pause":
                    self._json(state.pause_training(resume=False))
                elif u.path == "/api/train/resume":
                    self._json(state.pause_training(resume=True))
                elif u.path == "/api/train/new_network":
                    self._json(state.new_network(body))
                elif u.path == "/api/eval/action":
                    self._json(
                        state.eval_action(
                            body["cmd"],
                            float(body.get("param1", 0.0)),
                            float(body.get("param2", 0.0)),
                        )
                    )
                elif u.path == "/api/eval/atlas":
                    self._json(state.load_atlas(body["template"], body["atlas"]))
                elif u.path == "/api/model/reorder":
                    self._json(state.reorder_channels(body["order"]))
                elif u.path == "/api/console/run":
                    self._json(state.console_run(body["cmd"]))
                elif u.path == "/api/settings":
                    self._json(state.set_option_overrides(body.get("options", {})))
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                self._json({"error": str(e)}, 500)

    return Handler


def serve(host: str = "127.0.0.1", port: int = 8642, asset_root: str | None = None,
          device=None):
    state = AppState(asset_root, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    print(f"unet-studio-tpu-torch UI on {state.device} at "
          f"http://{host}:{server.server_address[1]}/")
    server.serve_forever()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="unet-studio-tpu-torch-ui")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--asset_root", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N, or cpu; with no GPU only cpu runs")
    a = p.parse_args(argv)
    serve(a.host, a.port, a.asset_root, a.device)


if __name__ == "__main__":
    main()
