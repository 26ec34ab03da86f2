"""Root pytest plugin: which tests of `tests/` the default `-m 'not slow'` run leaves out.

pytest loads this file for every run under the repository root, before the
files of `tests/`; the `slow` marker itself is registered in `tests/conftest.py`.
"""

import pytest

# The two longest tests of the suite, marked `slow` here so that their file
# stays as it is. Each takes an eager whole-network gradient through
# interpret-mode Pallas kernels: 468 s and 366 s alone in one process on an
# 8-core CPU. Both compare the JAX package's packed forward with its own plain
# forward, so they check the JAX package against itself and no change to the
# port can move their result. `test_forward_packed_train_grads_c128` keeps a
# whole-network packed-versus-plain gradient in the default run. Run these two
# with `python -m pytest -m slow -p no:randomly tests/test_packed.py`.
TIER1_SLOW = {
    ("test_packed.py", "test_forward_packed_train_grads"),
    ("test_packed.py", "test_packed_head_planes_loss_parity"),
}


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # tryfirst: the marker must be on before pytest's own `-m` deselection
    for item in items:
        if (item.path.name, item.name) in TIER1_SLOW:
            item.add_marker(pytest.mark.slow)
