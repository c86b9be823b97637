"""The projection products of a dense decoder's layers, in layer order,
through the port's ``kernels/matmul/ops.py::matmul`` with ``config=None``
(each product resolves its configuration by ``lookup``).

Every layer has weights of its own, drawn from the seed, so that the
cache holds no weight from one call to the next; the activations of the
``tokens`` rows are drawn once per input width (``x @ W`` with x (M, K)).
Set-up tunes each distinct (M, N, K) with the port's ``tune_kernel``.
"""

from __future__ import annotations

import random
from typing import Dict

import torch

from gpubench import checks, opstream, roofline, traffic
from gpubench.reference import ops as ref_ops


def make_inputs(run):
    """(products, {product: (L, K, N) weights}, {K: (M, K) activations})."""
    t, cfg = run.traffic, run.cfg
    dtype = getattr(torch, t["dtype"])
    M, L = t["tokens"], cfg["num_hidden_layers"]
    products = roofline.dense_products(cfg)
    weights = {name: traffic.stacked_weights(K, N, L, dtype, run.device,
                                             run.seed, name)
               for name, K, N in products}
    inputs = {K: traffic.normal((M, K), 1.0, dtype, run.device, run.seed,
                                f"inputs/{K}")
              for K in sorted({K for _, K, _ in products})}
    return products, weights, inputs


class Cell(opstream.OpStream):
    def __init__(self, run):
        from repro_torch.kernels.matmul.ops import GEMM, matmul
        self.run, t, cfg = run, run.traffic, run.cfg
        dtype = getattr(torch, t["dtype"])
        M, L = t["tokens"], cfg["num_hidden_layers"]
        with run.phase("load"):
            products, self.weights, self.inputs = make_inputs(run)
        self.calls = [
            opstream.Call(name, (name, i), matmul,
                          (self.inputs[K], self.weights[name][i]),
                          roofline.gemm_flops(M, N, K),
                          roofline.gemm_bytes(M, N, K, dtype.itemsize))
            for i in range(L) for name, K, N in products]
        self.samples_per_tag = t["samples_per_product"]
        self.segment_calls = t["trace_passes"] * len(self.calls)
        shapes = [{"M": M, "N": N, "K": K, "dtype": t["dtype"]}
                  for (N, K) in sorted({(N, K) for _, K, N in products})]
        self.tune(GEMM, shapes, t["budget"], t["strategy"], t["search_seed"],
                  tol=3e-2)
        self.warm_up()

    def check(self) -> Dict[str, float]:
        worst = 0.0
        for (name, i), out in self.samples:
            w = self.weights[name][i]
            ref = ref_ops.matmul(self.inputs[w.shape[0]], w)
            worst = max(worst, checks.row_error(out, ref))
            del ref
        return {"out_err": worst}


def tiny(cfg: Dict, t: Dict):
    """A size a CPU test holds: a small dense decoder's products at 64
    tokens, a search of 4 points, 2 samples a product."""
    cfg.update(traffic.TINY_LM)
    t.update(tokens=64, budget=4, samples_per_product=2)
    return cfg, t


#: plant(monkeypatch) of each fault the window's calls can have
FAULTS = opstream.FAULTS


def control(run, precision: str) -> Dict[str, float]:
    """The number compared where the reference computed in ``precision``
    stands in the program's place, on as many calls a product as a run
    samples, drawn from the seed."""
    products, weights, inputs = make_inputs(run)
    rng = random.Random(run.seed)
    worst = 0.0
    for name, K, _ in products:
        for _ in range(run.traffic["samples_per_product"]):
            w = weights[name][rng.randrange(len(weights[name]))]
            out = ref_ops.matmul(inputs[K], w, precision)
            worst = max(worst, checks.row_error(out, ref_ops.matmul(inputs[K],
                                                                    w)))
    return {"out_err": worst}
