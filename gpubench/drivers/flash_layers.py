"""Causal self-attention of one sequence over all of a configuration's
query heads, once per layer, through the port's
``kernels/attention/ops.py::flash_attention`` with ``config=None`` (one
launch a call; the configuration resolves by ``lookup``).

A few seeded (q, k, v) sets are cycled.  Where the configuration has
fewer KV heads than query heads, k and v are drawn for the KV heads and
repeated to the query heads once, in set-up, as the port's models do
(``repeat_interleave``), so the op takes contiguous operands of MHA
shape.  Set-up tunes the shape with the port's ``tune_kernel``.
"""

from __future__ import annotations

import random
from typing import Dict

import torch

from gpubench import checks, opstream, roofline, traffic
from gpubench.reference import ops as ref_ops


def make_sets(run):
    """The seeded (q, k, v) sets, each (H, S, D), k and v repeated from the
    KV heads to the query heads."""
    t, cfg = run.traffic, run.cfg
    dtype = getattr(torch, t["dtype"])
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    S, D = t["seq_len"], cfg["head_dim"]
    sets = []
    for i in range(t["input_sets"]):
        q = traffic.normal((H, S, D), 1.0, dtype, run.device, run.seed,
                           f"q/{i}")
        k, v = (traffic.normal((KV, S, D), 1.0, dtype, run.device, run.seed,
                               f"{n}/{i}")
                .repeat_interleave(H // KV, dim=0).contiguous()
                for n in ("k", "v"))
        sets.append((q, k, v))
    return sets


class Cell(opstream.OpStream):
    def __init__(self, run):
        from repro_torch.kernels.attention.ops import (FLASH_ATTENTION,
                                                       flash_attention)
        self.run, t, cfg = run, run.traffic, run.cfg
        dtype = getattr(torch, t["dtype"])
        H = cfg["num_attention_heads"]
        S, D, causal = t["seq_len"], cfg["head_dim"], t["causal"]
        with run.phase("load"):
            self.sets = make_sets(run)
        self.causal = causal
        flops = (roofline.flash_flops(H, S, D) if causal
                 else 2 * roofline.flash_flops(H, S, D) * S / (S + 1))
        call = lambda q, k, v: flash_attention(q, k, v, causal=causal)
        self.calls = [opstream.Call("attention", i, call, self.sets[i], flops,
                                    roofline.flash_bytes(H, S, D,
                                                         dtype.itemsize))
                      for i in range(len(self.sets))]
        self.samples_per_tag = t["samples"]
        self.segment_calls = t["trace_calls"]
        shape = {"Sq": S, "Sk": S, "D": D, "causal": causal,
                 "dtype": t["dtype"]}
        self.tune(FLASH_ATTENTION, [shape], t["budget"], t["strategy"],
                  t["search_seed"], tol=3e-2)
        self.warm_up()

    def check(self) -> Dict[str, float]:
        worst = 0.0
        for i, out in self.samples:
            ref = ref_ops.attention(*self.sets[i], causal=self.causal)
            worst = max(worst, checks.row_error(out, ref))
            del ref
        return {"out_err": worst}


def tiny(cfg: Dict, t: Dict):
    """A size a CPU test holds: 4 query heads over 1 KV head of 32 at 64
    positions, a search of 4 points, 2 input sets, 2 traced calls."""
    cfg.update(num_attention_heads=4, num_key_value_heads=1, head_dim=32)
    t.update(seq_len=64, budget=4, trace_calls=2, input_sets=2)
    return cfg, t


#: plant(monkeypatch) of each fault the window's calls can have
FAULTS = opstream.FAULTS


def control(run, precision: str) -> Dict[str, float]:
    """The number compared where the reference computed in ``precision``
    stands in the program's place, on as many calls as a run samples,
    drawn from the seed."""
    sets = make_sets(run)
    rng = random.Random(run.seed)
    causal, worst = run.traffic["causal"], 0.0
    for _ in range(run.traffic["samples"]):
        s = sets[rng.randrange(len(sets))]
        out = ref_ops.attention(*s, causal=causal, precision=precision)
        worst = max(worst, checks.row_error(
            out, ref_ops.attention(*s, causal=causal)))
        del out
    return {"out_err": worst}
