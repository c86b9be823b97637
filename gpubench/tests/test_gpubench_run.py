"""The command without a card, and the paths a run writes."""

import os
import shutil
import subprocess
import sys

import pytest

from gpubench import harness


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "granite-3-2b.train", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_without_a_card_it_fails_and_prints_no_result():
    _no_card()
    out = _run(harness.ROOT)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_it_fails_and_prints_no_result(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = _run(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""


def test_every_path_a_run_sets_is_in_the_checkout_or_tmpdir(tmp_path,
                                                            monkeypatch):
    sys.path.insert(0, os.path.join(harness.ROOT, "gpubench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
                "REPRO_TUNE_CACHE", "USE_FLAX"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    tmpdir = run.prepare_environment()
    assert tmpdir.startswith(str(tmp_path))
    assert os.environ["REPRO_TUNE_CACHE"].startswith(tmpdir)
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR",
                "CUDA_CACHE_PATH"):
        assert os.environ[key].startswith(os.path.join(harness.ROOT,
                                                       "build"))
    # the program's own build cache is inside the checkout too
    from repro_torch.core.paths import KERNEL_BUILD_DIR
    assert KERNEL_BUILD_DIR.startswith(harness.ROOT)
    # the trainer's checkpoint directory is the run's temporary one, and
    # no step of a window reaches its checkpoint interval
    from conftest import driver_of, tiny_files
    import torch
    r = harness.Run("granite-3-2b.train", *tiny_files("granite-3-2b.train")[1:],
                    1, 1.0, False, torch.device("cpu"), tmpdir)
    cell = driver_of("granite-3-2b.train").Cell(r)
    assert cell.trainer.tc.ckpt_dir.startswith(tmpdir)
    assert cell.trainer.tc.ckpt_every >= 10 ** 9
