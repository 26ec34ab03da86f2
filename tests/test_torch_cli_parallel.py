"""The port's CLI with ``--data_parallel`` and ``--coordinator`` on the
CPU.

``--data_parallel 2 --device cpu`` starts two gloo ranks of its own (one
process each), so it runs in a child process of its own session with a
time limit: a hang kills that session and fails this test instead of the
suite's run.  ``--coordinator`` runs as on several hosts: two CLI
processes, started here with ``RANK`` and ``WORLD_SIZE`` as torchrun
sets them, each in its own session under the same limit.  Each run
trains 2 epochs on a 16^3 phantom; rank 0 alone reports and writes the
final model.  A data axis larger than the devices there are returns 1
with ``error:`` (the JAX package's ``make_mesh`` raises ``ValueError``).
"""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np

from unet_studio_tpu_torch import cli
from unet_studio_tpu_torch.io.nifti import write_nifti
from unet_studio_tpu_torch.models.serialize import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180
ARCH = "\n".join(
    [
        "conv8,ks3,stride1+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu",
        "conv16,ks3,stride2+norm,leaky_relu+conv_trans16,ks2,stride2",
        "conv16,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1+conv_trans8,ks2,stride2",
        "conv8,ks3,stride1+norm,leaky_relu+conv3,ks1,stride1",
    ]
)
# one thread per process (each rank shares out its parent's): the
# suite's other workers keep their cores
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}
QUIET = ["--downsample_x", "0", "--downsample_y", "0", "--downsample_z", "0", "--noise", "0",
         "--ambient", "0", "--diffuse", "0", "--specular", "0", "--rubber_stamping", "0",
         "--perlin_texture", "0", "--zero_background", "4"]


def _run(argvs, envs) -> list[str]:
    """Run the commands at once, each in its own session, and return
    their outputs; past ``TIMEOUT_S`` kill every session and fail."""
    procs = [subprocess.Popen(a, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for a, e in zip(argvs, envs)]
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the ranks did not finish within {TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)  # the CLI and any ranks it started
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _train_argv(bids: str, model: str, *extra) -> list[str]:
    return [sys.executable, "-m", "unet_studio_tpu_torch", "--action", "train", "--model", model,
            "--bids", bids, "--batch_size", "2", "--epoch", "2", "--device", "cpu",
            "--architecture", ARCH, "--compute_dtype", "float32", *QUIET, *extra]


def _bids(root: str) -> str:
    n = 16
    z, y, x = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    lab = (r < n / 3).astype(np.int16)
    lab[r < n / 6] = 2
    img = (np.clip(1.0 - r / (n / 2), 0, 1) * (lab > 0)).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    write_nifti(os.path.join(root, "tpl-A_T1w.nii.gz"), img, is_mni=True)
    write_nifti(os.path.join(root, "tpl-A_dseg.nii.gz"), lab, is_mni=True)
    return root


def test_cli_data_parallel_two_ranks(tmp_path):
    bids = _bids(str(tmp_path / "bids"))
    model = str(tmp_path / "m.nz")
    (out,) = _run([_train_argv(bids, model, "--data_parallel", "2")], [ONE_THREAD])
    assert "device mesh: 2 x data (cpu)" in out
    # rank 0 alone prints the chart's header, its start and its save
    assert out.count("starting epoch: 0") == 1
    assert out.count(f"save model to {model}.final.nz") == 1
    assert sum(line.startswith("1" + " " * 50 + "0.1") for line in out.splitlines()) == 1
    trained = load_model(model + ".final.nz", device="cpu")
    assert len(trained.training_errors) == 6 and np.all(np.isfinite(trained.training_errors))


def test_cli_coordinator_two_processes(tmp_path):
    bids = _bids(str(tmp_path / "bids"))
    model = str(tmp_path / "m.nz")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = _train_argv(bids, model, "--coordinator", f"127.0.0.1:{port}")
    outs = _run([argv, argv], [{**ONE_THREAD, "RANK": str(r), "WORLD_SIZE": "2"}
                               for r in (0, 1)])
    assert all("device mesh: 2 x data (cpu)" in out for out in outs)
    assert f"save model to {model}.final.nz" in outs[0]
    assert "save model to" not in outs[1]  # rank 1 writes nothing
    trained = load_model(model + ".final.nz", device="cpu")
    assert len(trained.training_errors) == 6 and np.all(np.isfinite(trained.training_errors))


def test_cli_data_parallel_beyond_the_devices(tmp_path, capsys):
    bids = _bids(str(tmp_path / "bids"))
    n = (os.cpu_count() or 1) + 1
    rc = cli.main(["--action", "train", "--model", str(tmp_path / "m.nz"), "--bids", bids,
                   "--batch_size", str(n), "--epoch", "1", "--device", "cpu",
                   "--architecture", ARCH, "--data_parallel", str(n)])
    err = capsys.readouterr().err
    assert rc == 1 and f"error: need {n} devices, have {n - 1}" in err
    assert not os.path.exists(tmp_path / "m.nz.final.nz")
    rc = cli.main(["--action", "train", "--model", str(tmp_path / "m.nz"), "--bids", bids,
                   "--batch_size", "2", "--epoch", "1", "--device", "cpu",
                   "--architecture", ARCH, "--data_parallel", "1", *QUIET])
    assert rc == 0 and "device mesh: 1 x data (cpu)" in capsys.readouterr().out
