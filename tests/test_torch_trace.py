"""The port's spans and counters (``repro_torch.core.trace``) and what
``tools/trace_cell.py`` reads from them, on the CPU.

Every test that turns recording on turns it off again (``recording``), so
the module's default, off, holds for every other test in the process."""

import os
import sys
import threading
import time
import tracemalloc
import types

import numpy as np
import pytest
import torch

from repro_torch.core import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import trace_cell  # noqa: E402


@pytest.fixture
def recording():
    trace.take()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.take()


@pytest.fixture
def tune_record(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tuned.json"))
    return tmp_path


def names(spans):
    return [s.name for s in spans]


# ------------------------------------------------------------ the module

def test_recording_is_off_by_default():
    assert trace._on is False
    with trace.span("a"):
        trace.count("c")
    assert trace.take() == {"spans": [], "counters": {}}


def test_a_disabled_span_is_one_shared_object_and_allocates_nothing():
    assert trace.span("a") is trace.span("b")
    with trace.span("warm"):
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("x"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, trace.__file__)]
    grown = [d for d in after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno") if d.size_diff > 0]
    assert grown == []
    assert trace.take()["spans"] == []


def test_count_and_take_return_the_records_and_clear_them(recording):
    trace.count("a")
    trace.count("a", 4)
    trace.count("b")
    with trace.span("s"):
        pass
    got = trace.take()
    assert got["counters"] == {"a": 5, "b": 1}
    (s,) = got["spans"]
    assert (s.name, s.parent, s.thread) == ("s", None, threading.get_ident())
    assert 0 < s.start_ns <= s.end_ns
    assert trace.take() == {"spans": [], "counters": {}}


def test_spans_nest_per_thread_when_two_threads_record_at_once(recording):
    inside = threading.Barrier(2, timeout=30)
    idents = {}

    def work(i):
        idents[i] = threading.get_ident()
        with trace.span(f"outer{i}"):
            with trace.span(f"inner{i}"):
                inside.wait()      # both inner spans open at once
            with trace.span(f"second{i}"):
                pass
    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = trace.take()["spans"]
    assert len(spans) == 6
    for s in spans:
        i = int(s.name[-1])
        assert s.thread == idents[i]
        assert s.parent == (None if s.name.startswith("outer")
                            else f"outer{i}")


def test_timed_reads_the_clock_with_recording_off():
    with trace.timed("t") as clock:
        time.sleep(0.01)
    assert clock.seconds >= 0.01
    assert trace.take()["spans"] == []


def test_an_enabled_span_is_a_profiler_event_only_under_a_profiler(
        recording, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe.span"):
            torch.ones(4).sum()
    assert "probe.span" in [e.name for e in prof.events()]

    def refuse(name):
        raise AssertionError("record_function without a profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with trace.span("quiet"):
        pass
    assert names(trace.take()["spans"]) == ["probe.span", "quiet"]


def test_a_cpu_matmul_records_its_lookup_inside_the_op(recording,
                                                       tune_record):
    from repro_torch.kernels.matmul.ops import matmul
    out = matmul(torch.randn(32, 16), torch.randn(16, 8))
    assert out.shape == (32, 8)
    got = trace.take()
    by_name = {s.name: s for s in got["spans"]}
    assert set(by_name) == {"op.matmul", "registry.lookup"}
    assert by_name["registry.lookup"].parent == "op.matmul"
    assert by_name["op.matmul"].parent is None
    assert got["counters"] == {"registry.lookup.heuristic": 1}


def test_the_engine_totals_are_the_tune_spans_clock(recording, tune_record):
    from repro_torch.core import WallClockEvaluator
    from repro_torch.core.profiles import H100_SXM
    from repro_torch.kernels.matmul.ops import GEMM
    from repro_torch.tune.api import tune_kernel
    shape = {"M": 64, "N": 64, "K": 32, "dtype": "float32"}
    out = tune_kernel(GEMM, shape, strategy="random", budget=3, seed=0,
                      evaluator=WallClockEvaluator(device="cpu", warmup=1,
                                                   repeats=2),
                      profile=H100_SXM, record=False)
    spans = trace.take()["spans"]
    stats = out.engine_stats
    for key, name in (("compile_total_s", "tune.compile"),
                      ("measure_total_s", "tune.measure")):
        total = sum(trace_cell.span_s(s) for s in spans if s.name == name)
        assert total > 0 and stats[key] == pytest.approx(total, abs=2e-6)
    assert names(spans).count("tune.inputs") == 1
    assert sum(n == "tune.measure" for n in names(spans)) \
        == stats["unique_configs"]


# ------------------------------------------------- tools/trace_cell.py

def rec(name, start_ms, end_ms, thread=1, parent=None):
    return trace.SpanRecord(name, parent, thread, int(start_ms * 1e6),
                            int(end_ms * 1e6))


def phases(setup=(), window=(), segment=(), extra=(), counters=None):
    return {"setup": {"spans": list(setup), "counters": {}},
            "window": {"spans": list(window), "counters": counters or {}},
            "segment": {"spans": list(segment), "counters": {}},
            "extra": {"spans": list(extra), "counters": {}}}


def test_figures_of_synthetic_records():
    setup = [rec("tune.inputs", 0, 2000), rec("tune.compile", 0, 500, 2),
             rec("tune.compile", 100, 900, 3), rec("tune.measure", 1000, 1300)]
    window = [rec("train.step", 0, 100), rec("train.host_read", 90, 100),
              rec("train.step", 100, 180), rec("train.host_read", 170, 180),
              rec("train.step", 180, 300), rec("train.host_read", 280, 300)]
    extra = []
    for i in range(4):      # the first call is skipped
        t = i * 1.0
        extra += [rec("op.matmul", t, t + 0.9),
                  rec("registry.lookup", t + 0.1, t + 0.2 + (i == 0)),
                  rec("build.load", t + 0.3, t + 0.35),
                  rec("kernel.launch", t + 0.5, t + 0.8)]
    segment = [rec("train.step", 0, 500), rec("train.step", 500, 1000)]
    got = trace_cell.figures(
        phases(setup, window, segment, extra,
               {"registry.lookup.exact": 3, "registry.lookup.heuristic": 1,
                "optim.adamw.fused": 1, "optim.adamw.leafwise": 3,
                "other": 9}),
        {"busy_s": 0.8, "device_s_by_span": {"train.forward": 0.2,
                                             "train.backward": 0.4,
                                             "train.update": 0.1}},
        skip_calls=1)
    expect = {"tune_inputs_s": 2.0, "tune_compile_s": 1.3,
              "tune_measure_s": 0.3, "train_issue_ms": 90.0,
              "lookup_exact_pct": 75.0, "adamw_fused_pct": 25.0,
              "op_call_us": 900.0,
              "op_lookup_us": 100.0, "op_build_us": 50.0,
              "op_launch_us": 300.0, "train_fwd_ms": 100.0,
              "train_bwd_ms": 200.0, "train_update_ms": 50.0,
              "busy_ms_per_step": 400.0}
    assert got == pytest.approx(expect)
    assert trace_cell.figures(phases(), {}) == {}


def test_nested_counts_only_the_same_threads_spans_inside():
    outer = [rec("op.matmul", 0, 10, thread=1)]
    spans = [rec("build.load", 1, 2, thread=1), rec("build.load", 1, 2, 2),
             rec("build.load", 9, 11, thread=1)]
    assert trace_cell.nested(outer, spans, "build.load") \
        == pytest.approx([1e-3])


def _event(name, start_us, end_us, cuda=False, ident=0, thread=1):
    dev = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, id=ident, thread=thread,
        device_type=dev.CUDA if cuda else dev.CPU,
        time_range=types.SimpleNamespace(start=start_us, end=end_us))


def test_a_kernel_belongs_to_the_span_that_holds_its_launch_on_any_thread():
    events = [
        _event("train.forward", 0, 100),
        _event("train.backward", 100, 300),
        _event("train.update", 300, 400),
        # autograd's thread launches inside train.backward's interval
        _event("cudaLaunchKernel", 150, 152, ident=7, thread=2),
        _event("bwd_kernel", 400, 460, cuda=True, ident=7),
        # a launch after train.backward, from the same thread
        _event("cudaLaunchKernel", 301, 302, ident=8, thread=2),
        _event("adam_kernel", 460, 500, cuda=True, ident=8),
        # a host operation whose id equals a kernel's is no launch
        _event("aten::mm", 10, 20, ident=9),
        _event("mm_kernel", 500, 510, cuda=True, ident=9),
    ]
    got = trace_cell.device_by_span(events, trace_cell.TRAIN_SPANS)
    assert got == pytest.approx({"train.forward": 0.0,
                                 "train.backward": 60e-6,
                                 "train.update": 40e-6})


def tiny_files(name):
    """The cell's files at a size a CPU test holds (float32)."""
    from gpubench import harness
    _, work, cfg = harness.cell_files(name)
    cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128,
               vocab_size=97, torch_dtype="float32")
    t = work["traffic"]
    if work["driver"] == "train_step":
        t.update(batch=4, seq_len=16, batches=4)
    else:
        t.update(tokens=64, budget=4, samples_per_product=2,
                 dtype="float32")
    return None, work, cfg


@pytest.mark.parametrize("name, figures", [
    ("granite-3-2b.train", {"train_issue_ms", "adamw_fused_pct"}),
    ("granite-3-2b.gemm-bf16", {"tune_inputs_s", "tune_compile_s",
                                "tune_measure_s", "lookup_exact_pct",
                                "op_call_us", "op_lookup_us"}),
])
def test_a_cpu_run_of_a_cell_reads_every_figure_the_cpu_has(
        name, figures, tmp_path, tune_record):
    out = trace_cell.run_cell(name, 2 ** 31 + 11, 0.3, torch.device("cpu"),
                              str(tmp_path), files=tiny_files(name))
    assert out["correct"] is True, out["checks"]
    assert set(out["figures"]) == figures
    # CPU leaves take AdamW's leafwise step: the fused share reads 0
    assert out["figures"].pop("adamw_fused_pct", 0.0) == 0.0
    assert all(np.isfinite(v) and v > 0 for v in out["figures"].values())
    assert trace._on is False
    if name.endswith(".train"):
        assert out["counters"]["window"]["optim.adamw.leafwise"] > 0
        assert {"train.forward", "train.backward", "train.update"} \
            <= set(out["trace"]["span_host_events"])
    else:
        assert out["figures"]["lookup_exact_pct"] == 100.0
        assert out["per_layer"]["op_host_us"] > 0


def test_cost_reads_a_span_and_a_counter_off_and_on():
    got = trace_cell.cost(2000)
    assert set(got) == {"loop_ns", "span_off_ns", "span_on_ns",
                        "count_off_ns", "count_on_ns"}
    assert all(v > 0 for v in got.values())
    assert trace._on is False and trace.take()["spans"] == []
