"""BENCHMARK.json against the benchmark's contract, and every cell and
metric resolving to its files."""

import json
import math
import os
import re

import pytest

from conftest import cell_names, driver_of
from gpubench import harness

SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpubench"]
    for path in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.endswith("_torch") and path != "benchmarks"
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32
    files = [w for w in cmd if "/" in w]
    assert files and all(w.split("/")[0] in SPEC["paths"] for w in files)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    seen = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
    everything = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
        + SPEC["per_layer"]
    for e in everything:
        assert NAME.match(e["name"]), e["name"]
        assert e["name"] not in seen
        seen.add(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_setup_bound():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_to_its_files(entry):
    _, work, cfg = harness.cell_files(entry["name"])
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    assert cfg["name"] == entry["config"]
    assert set(work) == {"driver", "traffic", "limits"}
    driver = harness.load_module("drivers", work["driver"])
    assert hasattr(driver.Cell, "window") and hasattr(driver, "control")
    assert work["limits"] and all(v > 0 for v in work["limits"].values())
    e2e = [m["name"] for m in harness.metrics_for(SPEC, "end_to_end",
                                                   entry["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.metrics_for(SPEC, "per_layer", entry["name"])
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", cell_names())
def test_every_driver_declares_its_cell_test_size_and_faults(name):
    """What the tests and the control call of a cell file's driver, so that
    a new driver needs no edit to them."""
    driver = driver_of(name)
    assert callable(driver.Cell) and callable(driver.control)
    assert callable(driver.tiny)
    assert driver.FAULTS and all(map(callable, driver.FAULTS.values()))


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_every_configuration_is_used_and_states_its_cuts(conf):
    assert conf["file"].startswith("gpubench/configs/")
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])
    cfg = harness.load_json(os.path.join(harness.ROOT, conf["file"]))
    assert cfg["reduced"] == conf["reduced"]
    assert cfg["source"].startswith(conf["source"])
    widths = re.compile(r"(hidden_size|intermediate|latent|state|proj|"
                        r"_dim$|_rank$|head_dim|expan|experts_per_tok)")
    assert not [k for k in conf["reduced"] if widths.search(k)]
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(conf["file"]) == 1


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(metric):
    reader = harness.load_module("metrics", metric["name"])
    assert callable(reader.read)
    assert metric["moves"] in [m["name"] for m in SPEC["end_to_end"]]
    for cell in metric.get("workloads", []):
        assert cell in [w["name"] for w in SPEC["workloads"]]


def test_layers_are_named_alike_and_listed_in_perf_md():
    with open(os.path.join(harness.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in SPEC["per_layer"]}:
        assert f"| {layer} |" in perf, layer


def test_readers_find_nothing_in_an_empty_run():
    class Empty:
        driver = "none"
        window, trace, spans, counters = {}, {}, {}, {}
    for m in SPEC["per_layer"]:
        assert harness.load_module("metrics", m["name"]).read(Empty) is None


def test_result_keys_and_checks_come_last():
    run = harness.Run("granite-3-2b.train", {"traffic": {}, "limits":
                                              {"loss_gap": 1.0}},
                      {}, 1, 1.0, False, __import__("torch").device("cpu"),
                      "")
    window = {"attempted": 3, "end_to_end": {"train_tokens_per_s": 5.0}}
    out = harness.finish(SPEC, run, window, None, 2.0, 0, "cpu",
                         {"loss_gap": 0.5}, 1)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True
    assert out["metrics"] == {"train_tokens_per_s": {"value": 5.0,
                                                     "unit": "tokens/s"},
                              "setup_s": {"value": 2.0, "unit": "s"}}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    bad = harness.finish(SPEC, run, window, None, 2.0, 0, "cpu",
                         {"loss_gap": math.nan}, 1)
    assert bad["correct"] is False
    json.dumps(bad)
