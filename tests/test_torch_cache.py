"""Tuned-config databases written by the port and by the JAX package are
one format: each reads and merges the other's file under identical keys."""

import json
import os

import pytest

pytest.importorskip("torch")

from repro.core import cache as ref_cache  # noqa: E402
from repro_torch.core import cache as port_cache  # noqa: E402

CFG = {"BLOCK_M": 128, "BLOCK_N": 64, "BLOCK_K": 32, "GRID_ORDER": "nm",
       "INNER_STEPS": 2, "ACC_DTYPE": "float32", "ACC_IN_OUTPUT": True,
       "TRANS_A": False}
SHAPE = {"M": 2048, "N": 2048, "K": 2048, "dtype": "float32"}


def _write(mod, path, time_s, objective=None):
    c = mod.TuningCache(str(path))
    assert c.record("gemm", "M2048_N2048_K2048_float32", "h100_sxm", CFG,
                    time_s, "annealing", 24, shape=SHAPE, failures=1,
                    objective=objective)
    c.save()
    return c


@pytest.mark.parametrize("objective", [None, "p99_time"])
def test_port_file_is_read_and_merged_by_the_reference(tmp_path, objective):
    _write(port_cache, tmp_path / "port.json", 5e-4, objective)
    ref = _write(ref_cache, tmp_path / "ref.json", 7e-4, objective)
    changed = ref.merge(str(tmp_path / "port.json"))
    assert list(changed) == list(
        port_cache.TuningCache(str(tmp_path / "port.json")).entries())
    entry = ref.get("gemm", "M2048_N2048_K2048_float32", "h100_sxm",
                    objective=objective)
    assert entry.time_s == 5e-4 and entry.config == CFG


@pytest.mark.parametrize("objective", [None, "p99_time"])
def test_reference_file_is_read_and_merged_by_the_port(tmp_path, objective):
    _write(ref_cache, tmp_path / "ref.json", 3e-4, objective)
    port = _write(port_cache, tmp_path / "port.json", 9e-4, objective)
    port.merge(str(tmp_path / "ref.json"))
    entry = port.get("gemm", "M2048_N2048_K2048_float32", "h100_sxm",
                     objective=objective)
    assert entry.time_s == 3e-4 and entry.config == CFG
    assert entry.evaluations == 48 and entry.failures == 2   # folded


def test_files_have_identical_keys_and_layout(tmp_path):
    _write(port_cache, tmp_path / "port.json", 5e-4)
    _write(ref_cache, tmp_path / "ref.json", 5e-4)
    with open(tmp_path / "port.json") as f:
        port = json.load(f)
    with open(tmp_path / "ref.json") as f:
        ref = json.load(f)
    assert port.keys() == ref.keys()
    for k in port:
        p, r = dict(port[k]), dict(ref[k])
        p.pop("timestamp"), r.pop("timestamp")
        assert p == r


def test_default_path_is_outside_the_jax_package(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    path = os.path.realpath(port_cache._default_path())
    ref_pkg = os.path.realpath(os.path.dirname(os.path.dirname(
        ref_cache.__file__)))
    assert not path.startswith(ref_pkg + os.sep)
    assert path.endswith(os.path.join("repro_torch", "tune",
                                      "tuned_configs.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/tmp/x.json")
    assert port_cache._default_path() == "/tmp/x.json"
