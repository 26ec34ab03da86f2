"""The `slow` split of `tests/test_packed.py` that the root `conftest.py` makes.

Collection only: nothing is compiled or run, so this costs seconds.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKED = {"test_forward_packed_train_grads", "test_packed_head_planes_loss_parity"}


def _collect(marker):
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-m", marker,
         "tests/test_packed.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return [line.split("::", 1)[1] for line in out.stdout.splitlines()
            if line.startswith("tests/test_packed.py::")]


def test_packed_slow_split():
    fast = _collect("not slow")
    assert len(fast) == 15, fast
    assert not MARKED & set(fast)
    assert "test_forward_packed_train_grads_c128" in fast
    assert sorted(_collect("slow")) == sorted(MARKED)
