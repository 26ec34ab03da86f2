"""The port's web UI and the last public names, on the CPU.

* The CLI's two repairs against the JAX CLI: ``--action train`` on a
  damaged ``.nz`` returns 1 with the same message, and ``--coordinator``
  defaults to ``UNET_TPU_COORDINATOR``.
* ``POSTPROC_TABLE``, ``AugOptions.to_dict``, ``scale_to_shape`` and
  ``normalize01`` against the JAX package's (f32, 1e-6).
* The server (``ui/server.py``), modelled on tests/test_ui.py: one
  class-scoped server on ``AppState(device="cpu")``, a 2-level model on a
  16^3 grid, the settings file under a temporary directory.  Its evaluate
  labels equal ``EvaluateEngine(device="cpu")``'s; training runs 2 epochs
  in the background, polled under its own time limit.  The JAX package is
  compared only where no JAX forward is compiled: ``/api/options``,
  ``_decimate_errors``, ``label_census`` and the page's ``/api/`` paths.

One intra-op thread: the server's threads and the tiny convolutions need
no more.
"""

import dataclasses
import json
import os
import re
import struct
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_studio_tpu import cli as jax_cli
from unet_studio_tpu.config import options as JO
from unet_studio_tpu.ops import augment as JA
from unet_studio_tpu.ops import resample as JR
from unet_studio_tpu.ui import server as JS
from unet_studio_tpu_torch import cli
from unet_studio_tpu_torch.config import options as TO
from unet_studio_tpu_torch.engine.evaluate import EvaluateEngine
from unet_studio_tpu_torch.io.nifti import write_nifti
from unet_studio_tpu_torch.models.serialize import load_model, save_model
from unet_studio_tpu_torch.models.unet3d import UNet3d
from unet_studio_tpu_torch.ops import augment as TA
from unet_studio_tpu_torch.ops import resample as TR
from unet_studio_tpu_torch.ui import server as TS
from torch_one_thread import one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# two levels at C = 16, 32: the entry, K3, K4 and the dual conv (their
# CPU twins) and the norms
ARCH = "\n".join([
    "conv16,ks3,stride1+norm,leaky_relu",
    "conv32,ks3,stride2+norm,leaky_relu+conv_trans16,ks2,stride2",
    "conv16,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1",
])
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
WAIT_S = 60  # each background wait (training, a console command)


def _phantom(n=16):
    z, y, x = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    label = (r < n / 3).astype(np.int16)
    label[r < n / 6] = 2
    img = (np.clip(1.0 - r / (n / 2), 0, 1) * (label > 0)).astype(np.float32)
    return img, label


def _png_size(png: bytes) -> tuple[int, int]:
    assert png[:8] == PNG_MAGIC
    w, h = struct.unpack(">II", png[16:24])
    return h, w


# ---------------------------------------------------------------------------
# the CLI's repairs
# ---------------------------------------------------------------------------


def test_train_on_damaged_model_returns_1_in_both_clis(tmp_path, capsys):
    """A truncated ``.nz`` (gzip raises EOFError): rc 1 and the same
    ``error: failed to load model from ...`` line from both CLIs
    (train.cpp:1110-1111)."""
    m = UNet3d.create(1, 3, ARCH, seed=0, device="cpu")
    good = str(tmp_path / "good.nz")
    save_model(good, m)
    bad = str(tmp_path / "bad.nz")
    with open(good, "rb") as f, open(bad, "wb") as g:
        g.write(f.read()[:100])
    img, lab = _phantom()
    write_nifti(str(tmp_path / "tpl-A_T1w.nii.gz"), img, is_mni=True)
    write_nifti(str(tmp_path / "tpl-A_dseg.nii.gz"), lab, is_mni=True)
    args = ["--action", "train", "--model", bad, "--bids", str(tmp_path)]
    errs = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        assert main(args + extra) == 1
        err = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("error:")]
        errs.append(err)
    assert errs[0] == errs[1] and len(errs[0]) == 1
    assert errs[0][0].startswith(f"error: failed to load model from {bad}: ")


def test_coordinator_default_reads_environment(monkeypatch):
    argv = ["--action", "train", "--model", "m.nz"]
    monkeypatch.setenv("UNET_TPU_COORDINATOR", "10.0.0.1:8476")
    got = cli.build_parser().parse_args(argv).coordinator
    assert got == jax_cli.build_parser().parse_args(argv).coordinator == "10.0.0.1:8476"
    monkeypatch.delenv("UNET_TPU_COORDINATOR")
    assert cli.build_parser().parse_args(argv).coordinator is None
    assert jax_cli.build_parser().parse_args(argv).coordinator is None


# ---------------------------------------------------------------------------
# the public names
# ---------------------------------------------------------------------------


def test_postproc_table_matches_jax():
    assert len(TO.POSTPROC_TABLE) == len(JO.POSTPROC_TABLE) == 18
    for t, j in zip(TO.POSTPROC_TABLE, JO.POSTPROC_TABLE):
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert [type(v) for v in dataclasses.astuple(t)] == \
            [type(v) for v in dataclasses.astuple(j)], t.id


def test_aug_options_to_dict_matches_jax():
    override = {"cropping": 3, "noise_mag": "0.35", "distortion_count": 5.0,
                "scaling_up": 2, "perlin_texture": 0}
    for t, j in ((TA.AugOptions(), JA.AugOptions()),
                 (TA.AugOptions.from_dict(override), JA.AugOptions.from_dict(override))):
        d = t.to_dict()
        assert d == j.to_dict()
        assert list(d) == [f.name for f in dataclasses.fields(TA.AugOptions)]
        assert TA.AugOptions.from_dict(d) == t  # the inverse of from_dict
    # the port's from_dict keeps int fields int (the JAX package's makes
    # them float, its string annotations never being ``int``)
    d = TA.AugOptions.from_dict(override).to_dict()
    assert [type(v) for v in d.values()] == \
        [type(v) for v in TA.AugOptions().to_dict().values()]
    assert [type(v) for v in TA.AugOptions().to_dict().values()] == \
        [type(v) for v in JA.AugOptions().to_dict().values()]


@pytest.mark.parametrize("method", ["linear", "majority"])
def test_scale_to_shape_matches_jax(method):
    rng = np.random.default_rng(3)
    vol = rng.random((8, 8, 8), np.float32)
    if method == "majority":
        vol = np.floor(vol * 4).astype(np.float32)
    up = TR.scale_to_shape(torch.from_numpy(vol), (12, 10, 6), method)
    ref = np.asarray(JR.scale_to_shape(jnp.asarray(vol), (12, 10, 6), method))
    assert up.shape == (12, 10, 6)
    np.testing.assert_allclose(up.numpy(), ref, rtol=0, atol=1e-6)
    back = TR.scale_to_shape(up, (8, 8, 8), method)
    ref_back = np.asarray(JR.scale_to_shape(jnp.asarray(ref), (8, 8, 8), method))
    np.testing.assert_allclose(back.numpy(), ref_back, rtol=0, atol=1e-6)


def test_normalize01_matches_jax():
    rng = np.random.default_rng(4)
    pos = rng.random((6, 5, 4), np.float32) * 3.0
    neg = -rng.random((6, 5, 4), np.float32)
    neg[0, 0, 0] = 0.0
    for v in (pos, neg):
        got = TR.normalize01(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, np.asarray(JR.normalize01(jnp.asarray(v))),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(TR.normalize01(torch.from_numpy(neg)).numpy(), neg)
    assert float(TR.normalize01(torch.from_numpy(pos)).max()) == 1.0


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_page_names_the_same_api_paths():
    def paths(pkg):
        with open(os.path.join(ROOT, pkg, "ui", "app.html")) as f:
            return set(re.findall(r"/api/[a-z_/]+", f.read()))

    port, ref = paths("unet_studio_tpu_torch"), paths("unet_studio_tpu")
    assert port == ref and len(ref) >= 18


def test_decimate_errors_matches_jax():
    errors = [float(np.sin(i)) for i in range(3 * 2500)]
    for n in (2500, 7, 1000):
        assert TS.AppState._decimate_errors(errors[: 3 * n]) == \
            JS.AppState._decimate_errors(errors[: 3 * n])
    flat, epochs = TS.AppState._decimate_errors(errors)
    assert len(epochs) <= 1000 and epochs[0] == 0 and epochs[-1] == 2499
    assert flat[-3:] == errors[-3:]


def _serve(state, handler_factory):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler_factory(state))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


class TestServer:
    @pytest.fixture(scope="class")
    def env(self, tmp_path_factory):
        """The server on the CPU, and the class's data: a 2-level model on
        a 16^3 grid, three source volumes, a one-template BIDS dir."""
        d = tmp_path_factory.mktemp("ui")
        os.environ["UNET_TPU_SETTINGS"] = str(d / "cfg" / "settings.json")
        model = UNet3d.create(1, 3, ARCH, seed=0, device="cpu")
        model.dim = (16, 16, 16)
        model_path = str(d / "m.nz")
        save_model(model_path, model, sloped=False)
        rng = np.random.default_rng(0)
        sources = []
        for name in ("sub-01_T1w", "sub-02_T1w", "sub-03_T1w"):
            p = str(d / f"{name}.nii.gz")
            write_nifti(p, rng.random((16, 16, 16)).astype(np.float32))
            sources.append(p)
        bids = d / "bids"
        bids.mkdir()
        img, lab = _phantom()
        write_nifti(str(bids / "tpl-A_T1w.nii.gz"), img, is_mni=True)
        write_nifti(str(bids / "tpl-A_dseg.nii.gz"), lab, is_mni=True)
        state = TS.AppState(device="cpu")
        srv, url = _serve(state, TS.make_handler)
        yield {"url": url, "state": state, "dir": d, "model": model_path,
               "sources": sources, "bids": str(bids)}
        if state.train_engine is not None:
            state.train_engine.stop()
        srv.shutdown()
        del os.environ["UNET_TPU_SETTINGS"]

    @staticmethod
    def get(env, path) -> bytes:
        return urllib.request.urlopen(env["url"] + path, timeout=WAIT_S).read()

    @staticmethod
    def post(env, path, body, headers=None):
        req = urllib.request.Request(env["url"] + path, data=json.dumps(body).encode(),
                                     method="POST", headers=headers or {})
        return json.loads(urllib.request.urlopen(req, timeout=WAIT_S).read())

    def test_index_assets_console(self, env):
        html = self.get(env, "/").decode()
        assert "UNet Studio" in html and "Evaluate" in html
        j = json.loads(self.get(env, "/api/assets"))
        assert set(j) == {"zoo", "templates", "atlases"}
        assert "lines" in json.loads(self.get(env, "/api/console"))
        with pytest.raises(urllib.error.HTTPError) as exc:
            self.get(env, "/api/no_such_endpoint")
        assert exc.value.code == 404

    def test_options_match_jax(self, env):
        got = json.loads(self.get(env, "/api/options"))
        srv, url = _serve(JS.AppState(), JS.make_handler)
        try:
            ref = json.loads(urllib.request.urlopen(url + "/api/options", timeout=WAIT_S).read())
        finally:
            srv.shutdown()
        assert got == ref
        pp = {o["id"] for o in got["postproc"] if o["kind"] == "button"}
        assert "defragment_each" in pp and "gaussian_smoothing" in pp

    def test_eval_flow_matches_engine(self, env):
        j = self.post(env, "/api/model/load", {"path": env["model"]})
        assert j["out_count"] == 3 and j["dim"] == [16, 16, 16]
        src = env["sources"][0]
        j = self.post(env, "/api/eval/run", {"source": src})
        assert j["dims"] == [16, 16, 16] and j["current"] == 0
        ref = next(iter(EvaluateEngine(load_model(env["model"], device="cpu"),
                                       device="cpu").run([src])))
        np.testing.assert_array_equal(env["state"].case.label, ref.label)
        png = self.get(env, "/api/eval/slice?axis=0&index=8&overlay=1&view=input")
        assert _png_size(png) == (16, 16)
        out = str(env["dir"] / "out.nii.gz")
        assert self.post(env, "/api/eval/save", {"path": out, "output_type": 0})["saved"] == out
        assert os.path.exists(out)

    def test_five_views_and_prob_channels(self, env):
        for view in TS.AppState.EVAL_VIEWS:
            png = self.get(env, f"/api/eval/slice?axis=1&index=8&view={view}")
            assert _png_size(png) == (16, 16), view
        for ch in (0, 1, 2):
            png = self.get(env, f"/api/eval/slice?axis=0&index=8&view=prob&channel={ch}")
            assert png[:8] == PNG_MAGIC, ch
        with pytest.raises(urllib.error.HTTPError) as exc:
            self.get(env, "/api/eval/slice?axis=0&index=8&view=bogus")
        assert exc.value.code == 500

    def test_every_postproc_button_returns_200(self, env):
        opts = json.loads(self.get(env, "/api/options"))
        buttons = [o["id"] for o in opts["postproc"] if o["kind"] == "button"]
        assert buttons == [o.id for o in TO.POSTPROC_TABLE if o.kind == "button"]
        for cmd in buttons:
            r = self.post(env, "/api/eval/action", {"cmd": cmd, "param1": 0.5, "param2": 1.0})
            assert r == {"ok": True, "cmd": cmd}
        assert self.post(env, "/api/eval/action", {"cmd": "no_such_command"})["ok"]
        png = self.get(env, "/api/eval/slice?axis=0&index=8&view=input&vmin=0.2&vmax=0.8")
        assert png[:8] == PNG_MAGIC

    def test_cross_origin_post_rejected(self, env):
        with pytest.raises(urllib.error.HTTPError) as exc:
            self.post(env, "/api/eval/action", {"cmd": "argmax"},
                      headers={"Origin": "http://evil.example"})
        assert exc.value.code == 403
        j = self.post(env, "/api/eval/action", {"cmd": "argmax"},
                      headers={"Origin": env["url"]})
        assert j["ok"]

    def test_batch_evaluate_and_save_all(self, env):
        srcs = env["sources"]
        j = self.post(env, "/api/eval/run", {"sources": srcs})
        assert len(j["cases"]) == 3 and j["current"] == 0
        assert all(not c["error"] for c in j["cases"])
        ref = list(EvaluateEngine(load_model(env["model"], device="cpu"), device="cpu").run(srcs))
        for case, r in zip(env["state"].cases, ref):
            np.testing.assert_array_equal(case.label, r.label)
        j2 = self.post(env, "/api/eval/select", {"index": 2})
        assert j2 == {"dims": [16, 16, 16], "path": srcs[2], "current": 2}
        self.post(env, "/api/eval/select", {"index": 0})
        out = str(env["dir"] / "sub-01_mask.nii.gz")
        j3 = self.post(env, "/api/eval/save_all", {"path": out, "output_type": 0})
        assert j3["errors"] == []
        assert sorted(j3["saved"]) == sorted(
            str(env["dir"] / f"sub-{i:02d}_mask.nii.gz") for i in (1, 2, 3))
        assert all(os.path.exists(p) for p in j3["saved"])

    def test_new_network_and_census_match_jax(self, env):
        bids = env["bids"]
        j = json.loads(self.get(env, "/api/train/label_census?bids=" + bids))
        assert j == JS.AppState().label_census(bids)
        assert j["max_label"] == 2 and j["pairs"][0]["template"] is True
        mp = str(env["dir"] / "nn.nz")
        j = self.post(env, "/api/train/new_network",
                      {"model": mp, "in_count": 1, "out_count": j["suggested_out_count"],
                       "architecture": ARCH, "dim": [16, 16, 16]})
        assert j == {"model": mp, "in_count": 1, "out_count": 3, "architecture": ARCH}
        assert load_model(mp, device="cpu").dim == (16, 16, 16)

    def test_reorder_and_pause_without_engine(self, env):
        assert self.post(env, "/api/model/reorder", {"order": [0, 2, 1]}) == {"out_count": 3}
        with pytest.raises(urllib.error.HTTPError) as exc:
            self.post(env, "/api/train/pause", {})
        assert exc.value.code == 500

    def test_console_runs_the_port_cli(self, env):
        src = env["sources"][1]
        cmd = (f"unet-studio-tpu-torch --action evaluate --model {env['model']} "
               f"--source {src} --device cpu")
        assert self.post(env, "/api/console/run", {"cmd": cmd}) == {"started": cmd}
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            lines = json.loads(self.get(env, "/api/console"))["lines"]
            if any("exited with code" in ln for ln in lines):
                break
            time.sleep(0.1)
        assert "[command exited with code 0]" in lines, lines[-5:]
        assert os.path.exists(src + ".result.nii.gz")

    def test_settings_persistence(self, env):
        j = self.post(env, "/api/settings", {"options": {"noise_mag": 0.35}})
        assert j["option_overrides"]["noise_mag"] == 0.35
        opts = json.loads(self.get(env, "/api/options"))
        assert next(o for o in opts["options"] if o["id"] == "noise_mag")["default"] == 0.35
        with open(os.environ["UNET_TPU_SETTINGS"]) as f:
            assert json.load(f)["option_overrides"]["noise_mag"] == 0.35
        st = json.loads(self.get(env, "/api/settings"))
        assert st["last_network"] == env["model"]
        assert st["mru_model_dirs"] and st["mru_source_dirs"]
        self.post(env, "/api/settings", {"options": {"noise_mag": None}})
        opts = json.loads(self.get(env, "/api/options"))
        assert next(o for o in opts["options"] if o["id"] == "noise_mag")["default"] == 0.2

    def test_training_to_the_end_and_aug_preview(self, env, monkeypatch):
        st = self.post(env, "/api/train/start", {"bids": env["bids"], "model": env["model"],
                                                 "batch_size": 2, "epoch": 2,
                                                 "learning_rate": 0.01})
        assert st == {"pairs": 1, "model": env["model"], "devices": 1}
        with pytest.raises(urllib.error.HTTPError) as exc:
            self.post(env, "/api/train/start", {"bids": env["bids"], "model": env["model"]})
        assert exc.value.code == 500  # training already running
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            s = json.loads(self.get(env, "/api/train/status"))
            if s["error_msg"] or s["epoch"] >= s["total_epochs"]:
                break
            time.sleep(0.1)
        env["state"].train_thread.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not env["state"].train_thread.is_alive()
        s = json.loads(self.get(env, "/api/train/status"))
        assert s["error_msg"] == "" and s["epoch"] == s["total_epochs"] == 2
        assert len(s["training_errors"]) == 6 and np.isfinite(s["training_errors"]).all()
        assert s["training_error_epochs"] == [0, 1] and len(s["testing_errors"]) == 6
        # the preview: the item on the full grid, the same bytes per seed
        shown = []
        render = TS.render_slice
        monkeypatch.setattr(TS, "render_slice",
                            lambda img, lab: shown.append((img, lab)) or render(img, lab))
        a = self.get(env, "/api/aug/preview?seed=3&axis=2")
        assert a == self.get(env, "/api/aug/preview?seed=3&axis=2")
        assert _png_size(a) == (16, 16)
        img, lab = shown[0]
        assert img.shape == lab.shape == (16, 16) and np.isfinite(img).all()
        assert set(np.unique(lab).tolist()) <= {0.0, 1.0, 2.0} and lab.max() > 0
        assert self.post(env, "/api/train/stop", {}) == {"stopped": True}
        assert json.loads(self.get(env, "/api/train/status"))["running"] is False
