"""Each cell driven on the CPU at a small size, past the harness's look
for a card: a sound run is correct, and a run whose timed path is broken
underneath, once for each fault the cell can have, is not."""

import time

import pytest
import torch

from conftest import cell_names, driver_of, tiny_files
from gpubench import harness

CELLS = cell_names()
MEASURED = [w["name"] for w in harness.spec()["workloads"]]


def drive(name, tmp_path, files, trace=False, seconds=0.3):
    return harness.run_cell(name, 2 ** 31 + 11, seconds, trace,
                            torch.device("cpu"), str(tmp_path),
                            time.perf_counter(), files=files)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, trace, tmp_path, tune_record):
    out = drive(name, tmp_path, tiny_files(name, "float32"), trace)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0
    assert out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    if not trace and name in MEASURED:
        assert "setup_s" in out["metrics"]
        assert set(out["metrics"]) == {
            m["name"] for m in harness.metrics_for(harness.spec(),
                                                   "end_to_end", name)}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


# ---------------------------------------------------------------- faults

CASES = [(n, f) for n in CELLS for f in driver_of(n).FAULTS]


@pytest.mark.parametrize("name,fault", CASES)
def test_broken_timed_path_is_not_correct(name, fault, tmp_path, tune_record,
                                          monkeypatch):
    files = tiny_files(name, "float32")
    driver_of(name).FAULTS[fault](monkeypatch)
    out = drive(name, tmp_path, files)
    assert out["correct"] is False, out["checks"]
