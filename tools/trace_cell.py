"""Run one benchmark cell with the port's spans and counters recording
(``repro_torch.core.trace``), and print what they read.

    python3 tools/trace_cell.py --workload <cell> --seed <n> --seconds <s>
    python3 tools/trace_cell.py --cost

A cell runs as ``gpubench/run.py --trace 1`` runs it (set-up, the
measured window, the traced segment under ``torch.profiler``, the
per-layer measurements after the window, then the comparison), with
recording on from before set-up to the end of those measurements and the
records taken at each boundary: ``setup``, ``window``, ``segment`` and
``extra``.  The last line of standard output is one JSON object: the
window's numbers, the benchmark's own per-layer metrics of the run, the
segment's trace summary, ``correct`` and :func:`figures`.  ``setup_s``
counts from the cell's set-up, not from the process's start.

In the segment's trace the program's spans are host events of the
profiler (``record_function``); a device event that bears a span's name
(the profiler's annotation of that span on the device) is left out of
the busy time and the idle gaps, and counted apart.

``--cost``: nanoseconds of one ``with span(...)`` and one ``count(...)``,
recording off and on (no profiler), and of the empty loop around them.

``--out FILE`` also writes the JSON object to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import types
from typing import Dict, List, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (os.path.join(ROOT, "src"), ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)

#: every span the port records
SPAN_NAMES = ("train.step", "train.host_read", "train.forward",
              "train.backward", "train.update", "op.matmul",
              "op.flash_attention", "op.conv2d", "registry.lookup",
              "build.load", "kernel.launch", "tune.inputs", "tune.compile",
              "tune.measure")
#: the spans whose kernels' device time is attributed in the segment
TRAIN_SPANS = ("train.forward", "train.backward", "train.update")
#: (figure, span) of an op call's parts, and of the search's
OP_PARTS = (("op_lookup_us", "registry.lookup"), ("op_build_us", "build.load"),
            ("op_launch_us", "kernel.launch"))
TUNE_PARTS = (("tune_inputs_s", "tune.inputs"),
              ("tune_compile_s", "tune.compile"),
              ("tune_measure_s", "tune.measure"))


def span_s(record) -> float:
    return (record.end_ns - record.start_ns) * 1e-9


def nested(outer: Sequence, spans: Sequence, name: str) -> List[float]:
    """For each record of ``outer``, the summed seconds of the ``name``
    records on its thread that lie inside it."""
    inner = [s for s in spans if s.name == name]
    return [sum(span_s(s) for s in inner if s.thread == o.thread
                and o.start_ns <= s.start_ns and s.end_ns <= o.end_ns)
            for o in outer]


def device_by_span(events, names: Sequence[str]) -> Dict[str, float]:
    """Device seconds of the kernels each span of ``names`` launched.  A
    device event belongs to the span whose host interval holds the start
    of the runtime call with the same correlation id, on any thread (the
    innermost where several do): autograd issues the backward's kernels
    from a thread of its own while the caller waits inside its span."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in host
             if e.name in names]
    runtime = {e.id: e.time_range.start for e in host
               if e.name.startswith("cu")}
    out = dict.fromkeys(names, 0.0)
    for e in events:
        if e.device_type != cuda or e.id not in runtime:
            continue
        t = runtime[e.id]
        holding = [(b - a, n) for a, b, n in spans if a <= t <= b]
        if holding:
            out[min(holding)[1]] += (e.time_range.end
                                     - e.time_range.start) / 1e6
    return out


def figures(records: Dict[str, Dict], trace_out: Dict,
            skip_calls: int = 0) -> Dict[str, float]:
    """What the records of one run read; a figure is left out where its
    spans or counters are absent.

    - ``tune_inputs_s``, ``tune_compile_s``, ``tune_measure_s``: sums of
      ``tune.inputs``, ``tune.compile`` and ``tune.measure`` in set-up
      (compiles overlap on the engine's threads, so their sum can exceed
      the wall time; the evaluator draws its inputs inside its first
      measurement of a shape, so ``tune.inputs`` lies inside
      ``tune.measure``);
    - ``train_issue_ms``: the median over the window's ``train.step`` of
      its length less its ``train.host_read``;
    - ``lookup_exact_pct``: 100 x ``registry.lookup.exact`` over every
      ``registry.lookup.*`` count of the window;
    - ``op_call_us``, ``op_lookup_us``, ``op_build_us``, ``op_launch_us``:
      the mean over the op calls of the measurements after the window,
      less the first ``skip_calls``, of the call's span and of its
      ``registry.lookup``, ``build.load`` and ``kernel.launch``;
    - ``train_fwd_ms``, ``train_bwd_ms``, ``train_update_ms``: device ms a
      traced step of the kernels launched in ``train.forward``,
      ``train.backward`` and ``train.update`` (:func:`device_by_span`);
      ``busy_ms_per_step``: the segment's device-busy ms a traced step.
    """
    out: Dict[str, float] = {}
    setup = records["setup"]["spans"]
    for key, name in TUNE_PARTS:
        found = [span_s(s) for s in setup if s.name == name]
        if found:
            out[key] = sum(found)
    window = records["window"]
    steps = [s for s in window["spans"] if s.name == "train.step"]
    if steps:
        reads = nested(steps, window["spans"], "train.host_read")
        out["train_issue_ms"] = statistics.median(
            (span_s(s) - r) * 1e3 for s, r in zip(steps, reads))
    lookups = {k: v for k, v in window["counters"].items()
               if k.startswith("registry.lookup.")}
    if lookups:
        out["lookup_exact_pct"] = (100.0 * lookups.get("registry.lookup.exact",
                                                       0)
                                   / sum(lookups.values()))
    extra = records["extra"]["spans"]
    calls = [s for s in extra if s.name.startswith("op.")][skip_calls:]
    if calls:
        out["op_call_us"] = statistics.fmean(map(span_s, calls)) * 1e6
        for key, name in OP_PARTS:
            if any(s.name == name for s in extra):
                out[key] = statistics.fmean(nested(calls, extra, name)) * 1e6
    traced_steps = sum(s.name == "train.step"
                       for s in records["segment"]["spans"])
    by_span = trace_out.get("device_s_by_span", {})
    if traced_steps and "busy_s" in trace_out:
        for key, name in zip(("train_fwd_ms", "train_bwd_ms",
                              "train_update_ms"), TRAIN_SPANS):
            out[key] = by_span[name] * 1e3 / traced_steps
        out["busy_ms_per_step"] = trace_out["busy_s"] * 1e3 / traced_steps
    return out


def _by_name(events) -> Dict[str, int]:
    """How many of ``events`` bear each span's name."""
    out: Dict[str, int] = {}
    for e in events:
        if e.name in SPAN_NAMES:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def traced(run, cell) -> Dict:
    """The cell's segment under ``torch.profiler``: the harness's trace
    summary of it without the device events named as spans, and each
    train span's device seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpubench import harness
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run.sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cell.segment()
        run.sync()
        window_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    kept = [e for e in events
            if not (e.device_type == cuda and e.name in SPAN_NAMES)]
    out = {"window_s": window_s,
           "span_device_events": _by_name(e for e in events
                                          if e.device_type == cuda),
           "span_host_events": _by_name(kept)}
    if run.device.type == "cuda":
        out.update(harness.read_trace(
            types.SimpleNamespace(events=lambda: kept), window_s))
    out["device_s_by_span"] = device_by_span(kept, TRAIN_SPANS)
    return out


def run_cell(name: str, seed: int, seconds: float, device, tmpdir: str,
             files=None) -> Dict:
    """One run of cell ``name`` with recording on; ``files`` (entry, cell
    file, configuration) stands in for the cell's files, as in
    ``gpubench.harness.run_cell``."""
    from gpubench import checks, harness
    from repro_torch.core import trace
    bench = harness.spec()
    _, work, cfg = files or harness.cell_files(name, bench)
    run = harness.Run(name, work, cfg, seed, seconds, True, device, tmpdir)
    driver = harness.load_module("drivers", work["driver"])
    records: Dict[str, Dict] = {}
    t_start = time.perf_counter()
    trace.enable()
    try:
        cell = driver.Cell(run)
        run.sync()
        records["setup"] = trace.take()
        t0 = time.perf_counter()
        window = cell.window(t0 + seconds)
        records["window"] = trace.take()
        trace_out = traced(run, cell)
        records["segment"] = trace.take()
        cell.extra()
        records["extra"] = trace.take()
    finally:
        trace.disable()
    readings = harness.Readings(run, window, trace_out)
    per_layer = {m["name"]: harness.load_module("metrics", m["name"])
                 .read(readings)
                 for m in harness.metrics_for(bench, "per_layer", name)}
    result = {"cell": name, "seed": seed, "setup_s": t0 - t_start,
              "window": {k: v for k, v in window.items()
                         if k not in ("samples", "step_s")},
              "per_layer": per_layer,
              "figures": figures(records, trace_out,
                                 getattr(cell, "BURST", 0)),
              "trace": trace_out,
              "counters": {phase: r["counters"]
                           for phase, r in records.items()}}
    cell.release()
    values = cell.check()
    result["correct"] = checks.judge(values, run.limits)
    result["checks"] = values
    return result


def cost(n: int = 200_000) -> Dict[str, float]:
    """Nanoseconds a ``with span(...)`` and a ``count(...)`` take, off and
    on, each with the empty loop's own time in it."""
    from repro_torch.core import trace
    out: Dict[str, float] = {}
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    out["loop_ns"] = (time.perf_counter_ns() - t0) / n
    for state in ("off", "on"):
        (trace.enable if state == "on" else trace.disable)()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("cost"):
                pass
        t1 = time.perf_counter_ns()
        for _ in range(n):
            trace.count("cost")
        t2 = time.perf_counter_ns()
        trace.disable()
        trace.take()
        out[f"span_{state}_ns"] = (t1 - t0) / n
        out[f"count_{state}_ns"] = (t2 - t1) / n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from gpubench import harness
    card = harness.nvidia_smi("name,power.limit")
    if args.cost:
        result = {"cost": cost(), "card": card}
    else:
        import shutil

        import torch

        from gpubench.run import prepare_environment
        if not torch.cuda.is_available():
            print("no CUDA card on this host", file=sys.stderr)
            return 2
        tmpdir = prepare_environment()
        try:
            result = run_cell(args.workload, args.seed, args.seconds,
                              torch.device("cuda", 0), tmpdir)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        result["card"] = card
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
