"""A closed loop of op calls, shared by the op cells' drivers: each call
is issued as soon as the previous one is enqueued, the window ends in a
synchronise, and a sample of the window's outputs, drawn from the seed
(a reservoir of ``k`` per tag over all the window's calls), is kept for
the comparison once the window has closed."""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from gpubench import roofline


@dataclasses.dataclass
class Call:
    """One op call: ``fn(*args)``; ``tag`` groups the calls the sample
    draws from, ``where`` names its inputs for the reference."""
    tag: str
    where: Any
    fn: Callable
    args: Tuple
    flops: float
    nbytes: float


class OpStream:
    """Drivers set ``run``, ``calls`` (one pass, in issue order),
    ``samples_per_tag`` and ``segment_calls``, and implement ``check()``
    over ``samples``: (``where``, output) pairs."""

    run: Any
    calls: List[Call]
    samples_per_tag: int

    def tune(self, kernel, shapes: List[Dict], budget: int, strategy: str,
             search_seed: int, tol: float) -> None:
        """Set-up's search of every shape key through the port's
        ``tune_kernel`` (a fresh record: every run searches), then each
        key's ``lookup`` provenance, which must be ``exact``."""
        from repro_torch.core.cache import default_cache
        from repro_torch.core.evaluators import WallClockEvaluator
        from repro_torch.core.profiles import device_profile
        from repro_torch.core.registry import lookup_resolved
        from repro_torch.tune.api import tune_kernel
        run = self.run
        profile = device_profile(run.device)
        t0 = time.perf_counter()
        with run.phase("tune"):
            for shape in shapes:
                if lookup_resolved(kernel, shape, profile=profile,
                                   cache=default_cache()).provenance \
                        == "exact":
                    # a record kept across runs (the control's readings);
                    # a benchmark run's record starts empty
                    run.log(f"{shape} is in the record: no search")
                    continue
                evaluator = WallClockEvaluator(atol=tol, rtol=tol,
                                               device=run.device)
                out = tune_kernel(kernel, shape, strategy=strategy,
                                  budget=budget, seed=search_seed,
                                  evaluator=evaluator, profile=profile,
                                  cache=default_cache())
                res = lookup_resolved(kernel, shape, profile=profile,
                                      cache=default_cache())
                best = out.result.best
                run.log(f"tuned {shape}: winner {best.config} "
                        f"({best.time * 1e3:.4f} ms, "
                        f"{out.result.evaluations} evaluations); lookup "
                        f"{res.provenance} {res.config}")
                if res.provenance != "exact":
                    raise RuntimeError(f"lookup of {shape} gave {res}")
        run.counters["tune_s"] = time.perf_counter() - t0

    def warm_up(self) -> None:
        with self.run.phase("warm-up"):
            for c in self.calls:
                c.fn(*c.args)

    def window(self, deadline: float) -> Dict:
        rng = random.Random(self.run.seed)
        k = self.samples_per_tag
        kept: Dict[str, List] = {}
        seen: Dict[str, int] = {}
        calls = flops = host = 0.0
        n = len(self.calls)
        t0 = time.perf_counter()
        now = t0
        while now < deadline:
            c = self.calls[int(calls) % n]
            out = c.fn(*c.args)
            after = time.perf_counter()
            host += after - now
            now = after
            calls += 1
            flops += c.flops
            seen[c.tag] = seen.get(c.tag, 0) + 1
            bucket = kept.setdefault(c.tag, [])
            if len(bucket) < k:
                bucket.append((c.where, out))
            else:
                j = rng.randrange(seen[c.tag])
                if j < k:
                    bucket[j] = (c.where, out)
            del out
        self.run.sync()
        elapsed = time.perf_counter() - t0
        self.samples = [s for b in kept.values() for s in b]
        return {"attempted": int(calls), "calls": int(calls),
                "seconds": elapsed, "flops": flops,
                "host_us_per_call": host / calls * 1e6,
                "end_to_end": {"op_tflops": flops / elapsed / 1e12}}

    def segment(self) -> None:
        """The traced stretch: ``segment_calls`` calls in issue order; its
        useful operations and least device time are counted."""
        n = self.segment_calls
        flops = bound = 0.0
        for i in range(n):
            c = self.calls[i % len(self.calls)]
            c.fn(*c.args)
            flops += c.flops
            bound += roofline.bound_s(c.flops, c.nbytes)
        self.run.counters["segment_flops"] = flops
        self.run.counters["segment_bound_s"] = bound

    def extra(self) -> None:
        """op_host_us: the host clock around each call, in bursts of
        ``BURST`` calls between synchronisations, so that no call waits
        for room in the launch queue; the first burst is not kept."""
        times = []
        for start in range(0, (self.BURSTS + 1) * self.BURST, self.BURST):
            self.run.sync()
            for i in range(start, start + self.BURST):
                c = self.calls[i % len(self.calls)]
                t0 = time.perf_counter()
                c.fn(*c.args)
                if start:
                    times.append(time.perf_counter() - t0)
        self.run.sync()
        self.run.spans["op_call_s"] = times

    BURST, BURSTS = 32, 8

    def release(self) -> None:
        self.calls = []


def _broken(change: Callable):
    """plant(monkeypatch): once set-up's warm-up has run (the search
    measured the sound kernel), every call of the window returns
    ``change`` of the op's output."""
    def plant(monkeypatch) -> None:
        warm = OpStream.warm_up

        def warm_then_break(self) -> None:
            warm(self)
            self.calls = [dataclasses.replace(
                c, fn=lambda *a, _fn=c.fn: change(_fn(*a)))
                for c in self.calls]
        monkeypatch.setattr(OpStream, "warm_up", warm_then_break)
    return plant


def _unwritten(out):
    return torch.zeros_like(out)


def _half_rows(out):
    out = out.clone()
    out[..., out.shape[-2] // 2:, :] = 0
    return out


def _row_altered(out):
    out = out.clone()
    out[..., 0, :] = out[..., out.shape[-2] // 2, :]
    return out


#: the faults an op cell's window can have: an output never written, half
#: its rows left out, one row of the answer altered where it is produced
FAULTS = {"output_unwritten": _broken(_unwritten),
          "half_rows_left_out": _broken(_half_rows),
          "answer_altered": _broken(_row_altered)}
