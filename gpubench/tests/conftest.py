"""gpubench's CPU tests (``python -m pytest -q gpubench/tests``).

Tests marked ``card`` need a CUDA card; a fixture decides, never an
import, so every worker collects the same tests."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)


def cell_names():
    """Every cell file under gpubench/workloads, in BENCHMARK.json or not
    (a cell kept for a later PR is tested all the same)."""
    from gpubench import harness
    return sorted(f[:-len(".json")] for f in os.listdir(
        os.path.join(harness.BENCH_DIR, "workloads")))


def cell_file(name):
    """The parsed ``workloads/<name>.json``."""
    from gpubench import harness
    return harness.load_json(os.path.join(harness.BENCH_DIR, "workloads",
                                          name + ".json"))


def driver_of(name):
    """The driver module that cell ``name``'s file names."""
    from gpubench import harness
    return harness.load_module("drivers", cell_file(name)["driver"])


def tiny_files(name, dtype=None):
    """(entry, cell file, configuration) of cell ``name`` at the size its
    driver's ``tiny`` gives; ``dtype`` replaces the op's type where the
    traffic states one, else the weights'.  The configuration is
    ``configs/<name up to its last dot>.json``."""
    from gpubench import harness
    work = cell_file(name)
    cfg = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                         name.rsplit(".", 1)[0] + ".json"))
    cfg, work["traffic"] = driver_of(name).tiny(cfg, work["traffic"])
    if dtype:
        if "dtype" in work["traffic"]:
            work["traffic"]["dtype"] = dtype
        else:
            cfg["torch_dtype"] = dtype
    return None, work, cfg


@pytest.fixture
def tune_record(tmp_path, monkeypatch):
    """A fresh tuning record for the test, as every run has."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tuned.json"))
    return tmp_path
