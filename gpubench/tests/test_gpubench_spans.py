"""The port's spans in a ``--trace 1`` run (``gpubench/spans.py``): the
device time under each span on a synthetic profiler record, the readers
of the records, and a traced CPU run that records set-up and the extra
segment and nothing that starts inside the window."""

import time
import types

import pytest
import torch

from conftest import cell_names, tiny_files
from gpubench import harness, spans


def _event(name, start_us, end_us, ident=0, thread=1, cuda=False):
    dev = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, id=ident, thread=thread,
        device_type=dev.CUDA if cuda else dev.CPU,
        time_range=types.SimpleNamespace(start=start_us, end=end_us))


def test_a_kernel_counts_under_every_span_that_holds_its_launch():
    events = [
        _event("train.step", 0, 500),
        _event("train.forward", 0, 100),
        _event("train.backward", 100, 300),
        _event("train.update", 300, 400),
        # autograd's thread launches inside train.backward's interval
        _event("cudaLaunchKernel", 150, 152, ident=7, thread=2),
        _event("bwd_kernel", 400, 460, cuda=True, ident=7),
        # the profiler's device annotation of a span is no kernel
        _event("train.backward", 400, 470, cuda=True, ident=7),
        # a launch after train.backward, from the same thread
        _event("cudaLaunchKernel", 301, 302, ident=8, thread=2),
        _event("adam_kernel", 460, 500, cuda=True, ident=8),
        # a host operation whose id equals a kernel's is no launch
        _event("aten::mm", 10, 20, ident=9),
        _event("mm_kernel", 500, 510, cuda=True, ident=9),
        # a launch outside every span
        _event("cudaLaunchKernel", 600, 601, ident=10),
        _event("late_kernel", 610, 620, cuda=True, ident=10),
    ]
    got = spans.device_by_span(events, ["train.step", "train.forward",
                                        "train.backward", "train.update"])
    assert got == pytest.approx({"train.step": 100e-6,
                                 "train.forward": 0.0,
                                 "train.backward": 60e-6,
                                 "train.update": 40e-6})


def test_records_reach_the_run_by_name_and_set_up_apart(tmp_path):
    run = harness.Run("c", {"traffic": {}, "limits": {}}, {}, 1, 1.0, True,
                      torch.device("cpu"), str(tmp_path))
    rec = lambda name, a, b: types.SimpleNamespace(  # noqa: E731
        name=name, start_ns=a, end_ns=b)
    spans.keep(run, {"spans": [rec("tune.inputs", 0, 2_000_000_000)],
                     "counters": {"registry.lookup.exact": 2}}, spans.SETUP)
    spans.keep(run, {"spans": [rec("train.host_read", 0, 10_000_000),
                               rec("train.step", 0, 30_000_000),
                               rec("train.host_read", 0, 10_000_000),
                               rec("train.step", 0, 50_000_000)],
                     "counters": {"registry.lookup.exact": 3}})
    want = {"setup/tune.inputs": [2.0], "train.host_read": [0.01, 0.01],
            "train.step": [0.03, 0.05]}
    assert set(run.spans) == set(want)
    for name, seconds in want.items():
        assert run.spans[name] == pytest.approx(seconds)
    assert run.counters == {"setup/registry.lookup.exact": 2,
                            "registry.lookup.exact": 3}


def _read(name, spans_, trace=None):
    r = types.SimpleNamespace(driver="none", window={}, trace=trace or {},
                              spans=spans_, counters={})
    return harness.load_module("metrics", name).read(r)


def test_the_readers_of_the_records():
    steps = {"train.step": [0.3, 0.32, 0.5], "train.host_read": [0.05] * 3}
    assert _read("train_issue_ms", steps) == pytest.approx(270.0)
    by_span = {"device_s_by_span": {"train.forward": 0.3,
                                    "train.backward": 0.6}}
    assert _read("train_fwd_ms", steps, by_span) == pytest.approx(100.0)
    assert _read("train_bwd_ms", steps, by_span) == pytest.approx(200.0)
    calls = {"op.matmul": [1e-3] * 3, "op.flash_attention": [1e-3],
             "build.load": [4e-4] * 4, "setup/build.load": [1.0]}
    assert _read("op_build_us", calls) == pytest.approx(400.0)
    assert _read("tune_inputs_s", {"setup/tune.inputs": [1.5, 2.0],
                                   "tune.inputs": [9.0]}) == 3.5
    # a step whose host read went unrecorded pairs with nothing
    assert _read("train_issue_ms", {"train.step": [0.3],
                                    "train.host_read": []}) is None


@pytest.mark.parametrize("name", cell_names())
def test_a_traced_run_records_no_span_inside_the_window(name, tmp_path,
                                                        tune_record,
                                                        monkeypatch):
    from repro_torch.core import trace
    taken, window = [], []
    take = trace.take

    def kept():
        out = take()
        taken.extend(out["spans"])
        return out
    monkeypatch.setattr(trace, "take", kept)
    driver = harness.load_module("drivers",
                                 tiny_files(name)[1]["driver"])
    timed = driver.Cell.window

    def window_timed(self, deadline):
        window.append(time.perf_counter_ns())
        try:
            return timed(self, deadline)
        finally:
            window.append(time.perf_counter_ns())
    monkeypatch.setattr(driver.Cell, "window", window_timed)
    out = harness.run_cell(name, 2 ** 31 + 19, 0.3, True,
                           torch.device("cpu"), str(tmp_path),
                           time.perf_counter(), files=tiny_files(name,
                                                                 "float32"))
    assert out["correct"] is True, out["checks"]
    assert trace._on is False
    start, end = window
    assert [s for s in taken if start <= s.start_ns <= end] == []
    assert any(s.end_ns < start for s in taken)
    assert any(s.start_ns > end for s in taken)
