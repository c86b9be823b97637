"""Where the port keeps what it makes at run time: ``build/`` at the root
of the checkout, found from this file rather than the working directory
(gitignored)."""

import os

#: root of the checkout: src/repro_torch/core/paths.py -> ../../..
REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         "..", ".."))
#: built kernel libraries and their compiler logs
KERNEL_BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
#: WallClockEvaluator's per-card measurement locks
LOCK_DIR = os.path.join(REPO_ROOT, "build", "locks")
