"""Rename-by-example: derive an output filename for file2 from the
(file1 -> file1_output) example pair.

Host analog of ``tipl::match_files`` as used by the reference's batch
save loops (mainwindow_evaluation.cpp:394, mainwindow_training.cpp:212):
the user names ONE result file, and every other checked volume's result
name is derived by applying the same source->output rewrite.  A copy of
unet_studio_tpu/utils/match.py.
"""

from __future__ import annotations

import os


def match_files(file1: str, file1_output: str, file2: str) -> str | None:
    """Given the example pair ``file1 -> file1_output``, derive file2's
    output name, or None when no consistent rewrite exists.

    The differing middle of file1 vs file2 (their longest common
    prefix/suffix stripped) is the per-case token; the output name is
    ``file1_output`` with file1's token replaced by file2's.
    """
    f1, f2 = str(file1), str(file2)
    out1 = str(file1_output)
    if f1 == f2:
        return out1
    # longest common prefix / suffix of the two SOURCE names
    p = 0
    while p < min(len(f1), len(f2)) and f1[p] == f2[p]:
        p += 1
    s = 0
    while (
        s < min(len(f1), len(f2)) - p
        and f1[len(f1) - 1 - s] == f2[len(f2) - 1 - s]
    ):
        s += 1
    tok1 = f1[p : len(f1) - s]
    tok2 = f2[p : len(f2) - s]
    if not tok1:
        # file1 is a strict substring boundary case: insert tok2 at the
        # same position in the output if the surrounding context matches
        return None
    # apply the rewrite to the example output: the source token must
    # appear there (search the basename first so directory components
    # named like the token don't misfire)
    d1, b1 = os.path.split(out1)
    if tok1 in b1:
        return os.path.join(d1, b1.replace(tok1, tok2, 1)) if d1 else b1.replace(tok1, tok2, 1)
    if tok1 in out1:
        return out1.replace(tok1, tok2, 1)
    return None
