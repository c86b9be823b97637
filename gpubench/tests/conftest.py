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


#: a small dense decoder of the configurations' shape
TINY_LM = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128,
               vocab_size=97)


def cell_names():
    """Every cell file under gpubench/workloads, in BENCHMARK.json or not
    (a cell kept for a later PR is tested all the same)."""
    from gpubench import harness
    return sorted(f[:-len(".json")] for f in os.listdir(
        os.path.join(harness.BENCH_DIR, "workloads")))


def tiny_files(name, dtype=None):
    """(entry, cell file, configuration) of cell ``name`` at a size a CPU
    test holds; ``dtype`` replaces the weights' or the op's type.  The
    configuration is ``configs/<name up to its last dot>.json``."""
    from gpubench import harness
    work = harness.load_json(os.path.join(harness.BENCH_DIR, "workloads",
                                          name + ".json"))
    cfg = harness.load_json(os.path.join(harness.BENCH_DIR, "configs",
                                         name.rsplit(".", 1)[0] + ".json"))
    t = work["traffic"]
    if work["driver"] == "train_step":
        cfg.update(TINY_LM)
        t.update(batch=4, seq_len=16, batches=4)
        if dtype:
            cfg["torch_dtype"] = dtype
    elif work["driver"] == "gemm_layers":
        cfg.update(TINY_LM)
        t.update(tokens=64, budget=4, samples_per_product=2)
    else:
        cfg.update(num_attention_heads=4, num_key_value_heads=1, head_dim=32)
        t.update(seq_len=64, budget=4, trace_calls=2, input_sets=2)
    if dtype and "dtype" in t:
        t["dtype"] = dtype
    return None, work, cfg


@pytest.fixture
def tune_record(tmp_path, monkeypatch):
    """A fresh tuning record for the test, as every run has."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tuned.json"))
    return tmp_path
