"""The harness: finds a cell's files by name, runs its driver's set-up,
the measured window, the traced segment and the comparison, and prints
the result line.

A cell ``<config>.<traffic>`` is ``workloads/<cell>.json`` (its traffic
parameters, its driver's name and its limits), ``configs/<config>.json``
and ``drivers/<driver>.py``; a per-layer metric is ``metrics/<name>.py``
with a ``read(readings)`` that returns a number or None.  A driver module
defines ``Cell(run)``, whose constructor is the set-up, with:

- ``window(deadline)``: closed-loop work until the host clock passes
  ``deadline``, ending in a synchronise; returns a dict with ``attempted``
  and the quantities the cell's end-to-end metrics are computed from
  (``end_to_end``, a dict of metric values);
- ``segment()``: a short steady stretch of the same work, which the
  harness traces;
- ``extra()``: per-layer measurements taken after the window (traced runs
  only); a traced run then runs ``segment()`` again with the port's
  spans and counters recording (``spans.py``), as set-up ran;
- ``release()`` and ``check()``: free the program's state, then compare
  with the reference and return {number: value}.

Beside ``Cell`` it defines ``control(run, precision[, fault])``, the
numbers compared where the reference stands in the program's place;
``tiny(cfg, traffic)``, the cell at a size a CPU test holds; ``FAULTS``,
{name: plant(monkeypatch)} of the faults its timed path can have; and,
where ``control`` takes them, ``REFERENCE_FAULTS``.  So a new model's
cell joins with new files only.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from . import checks, spans

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def spec() -> Dict[str, Any]:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(kind: str, name: str):
    """``gpubench/<kind>/<name>.py`` as a module (names may hold dots),
    loaded once a process: a fault a test plants in a driver's own module
    is the one its run calls."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod_name = f"gpubench.{kind}." + name.replace(".", "_").replace("-", "_")
    mod = sys.modules.get(mod_name)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sys.modules[mod_name] = mod
    sp.loader.exec_module(mod)
    return mod


def cell_files(name: str, bench: Optional[Dict[str, Any]] = None):
    """(BENCHMARK.json's entry, the cell's file, its configuration file)."""
    bench = bench or spec()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = load_json(os.path.join(BENCH_DIR, "workloads", name + ".json"))
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    return entry, work, cfg


def metrics_for(bench: Dict[str, Any], kind: str, cell: str) -> List[Dict]:
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') this cell
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi(fields: str) -> Optional[str]:
    """One line per card of ``nvidia-smi --query-gpu=<fields>``; None where
    there is no nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, f"--query-gpu={fields}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unreadable ({type(e).__name__})"
    return out.stdout.strip() or out.stderr.strip()


class Run:
    """What a driver gets: the cell's files, the seed, the device, the
    run's temporary directory, and places to record the set-up split,
    spans (host seconds of calls into a layer, the driver's own and, in a
    traced run, the port's) and counters."""

    def __init__(self, name: str, work: Dict, cfg: Dict, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 tmpdir: str):
        self.name, self.work, self.cfg = name, work, cfg
        self.traffic, self.limits = work["traffic"], work["limits"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.tmpdir = device, tmpdir
        self.phases: Dict[str, float] = {}
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Host seconds of a set-up step, kept under ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.phases[name] = self.phases.get(name, 0.0) \
                + time.perf_counter() - t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def log(self, msg: str) -> None:
        print(f"[{self.name}] {msg}", flush=True)


class Readings:
    """What a per-layer metric's reader reads."""

    def __init__(self, run: Run, window: Dict, trace: Optional[Dict]):
        self.driver = run.work["driver"]
        self.window = window
        self.trace = trace or {}
        self.spans, self.counters = run.spans, run.counters


def read_trace(prof, window_s: float) -> Dict[str, Any]:
    """Device busy seconds (the union of the device's activity intervals),
    the summed device seconds, and the breakdown: the 10 device operations
    that took most time, and the 10 longest idle gaps, each named by the
    innermost host operation running at its middle."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        (dev if e.device_type == cuda else host).append((span, e.name))
    by_name: Dict[str, float] = {}
    for (s, t), n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
    merged: List[List[float]] = []
    for (s, t), _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    idle = []
    for g, s, t in gaps:
        mid = (s + t) / 2
        inner = [(b - a, n) for (a, b), n in host if a <= mid <= b]
        idle.append([min(inner)[1] if inner else "host: no operation traced",
                     g / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s,
            "device_s": sum(by_name.values()), "device_events": len(dev),
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": idle}}


def traced(run: Run, cell) -> Dict[str, Any]:
    """The cell's segment under torch.profiler; on the CPU (tests) only its
    host time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run.sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cell.segment()
        run.sync()
        window_s = time.perf_counter() - t0
    if run.device.type != "cuda":
        return {"window_s": window_s}
    return read_trace(prof, window_s)


def result_metrics(bench: Dict, run: Run, window: Dict,
                   trace: Optional[Dict], setup_s: float) -> Dict[str, Dict]:
    """The result line's metrics: the cell's end-to-end ones (trace 0) or
    its per-layer ones (trace 1), each reader's number where it found
    one."""
    out: Dict[str, Dict] = {}
    if not run.trace:
        for m in metrics_for(bench, "end_to_end", run.name):
            value = (setup_s if m["name"] == "setup_s"
                     else window["end_to_end"].get(m["name"]))
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    readings = Readings(run, window, trace)
    for m in metrics_for(bench, "per_layer", run.name):
        value = load_module("metrics", m["name"]).read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, tmpdir: str, t_start: float,
             chips: int = 1, files=None) -> Dict[str, Any]:
    """One run of one cell; returns the result line's object.  The caller
    has checked the device.  ``files`` (entry, cell file, configuration)
    stands in for the cell's files (tests at a small size)."""
    bench = spec()
    _, work, cfg = files or cell_files(name, bench)
    run = Run(name, work, cfg, seed, seconds, trace, device, tmpdir)
    driver = load_module("drivers", work["driver"])
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        run.log(f"card {kind}; " + str(nvidia_smi("name,power.limit")))
    else:
        kind = "cpu"
    rec = spans.recorder() if trace else None
    if rec is not None:
        rec.take()
        rec.enable()
    try:
        cell = driver.Cell(run)
        run.sync()
    finally:
        if rec is not None:
            rec.disable()
            spans.keep(run, rec.take(), spans.SETUP)
    run.log("set-up s " + json.dumps(run.phases))
    run.log("clocks before the window: " + str(nvidia_smi(
        "clocks.sm,clocks.max.sm,temperature.gpu,power.draw")))
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    window = cell.window(t0 + seconds)
    run.log("clocks after the window: " + str(nvidia_smi(
        "clocks.sm,clocks.max.sm,temperature.gpu,power.draw")))
    run.log("window " + json.dumps(
        {k: v for k, v in window.items() if k != "samples"}))
    trace_out = None
    if trace:
        trace_out = traced(run, cell)
        run.log("trace " + json.dumps(
            {k: v for k, v in trace_out.items() if k != "breakdown"}))
        cell.extra()
        if rec is not None:
            by_span = spans.recorded_segment(run, cell, rec)
            if by_span is not None:
                trace_out["device_s_by_span"] = by_span
                run.log("device s by span " + json.dumps(by_span))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = cell.check()
    run.log(f"check s {time.perf_counter() - t_check:.3f}; peak memory "
            f"{peak} bytes")
    del cell
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of {', '.join(found)} are loaded")
    return finish(bench, run, window, trace_out, setup_s, peak, kind,
                  values, chips)


def finish(bench, run, window, trace_out, setup_s, peak, kind, values,
           chips) -> Dict[str, Any]:
    """The result line's object; ``checks`` comes last."""
    limits = run.limits
    correct = checks.judge(values, limits)
    result: Dict[str, Any] = {
        "correct": correct,
        "attempted": int(window["attempted"]),
        "failed": int(window.get("failed", 0)),
        "metrics": result_metrics(bench, run, window, trace_out, setup_s),
        "device": {"platform": "gpu" if run.device.type == "cuda" else "cpu",
                   "kind": kind, "count": chips, "memory_peak_bytes": peak},
    }
    if trace_out is not None and "busy_s" in trace_out:
        result["device"]["busy_s"] = trace_out["busy_s"]
        result["device"]["window_s"] = trace_out["window_s"]
        result["breakdown"] = trace_out["breakdown"]
    result["checks"] = {k: {"value": values.get(k), "limit": limits[k]}
                        for k in limits}
    return result
