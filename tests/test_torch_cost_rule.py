"""``core/cost.py``'s FLOP rule against XLA's ``HloCostAnalysis``, op by
op: each aten operation that ``OpTrace`` counts outside the product
formulas is traced on float32 tensors and held, FLOPs and
transcendentals, to ``cost_analysis()`` of the same function compiled
from ``jnp`` on the CPU (float32, so XLA adds no converts of its own).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core.cost import OpTrace, _cumsum_flops  # noqa: E402


def _xla(fn, *args):
    c = jax.jit(fn).lower(*args).compile().cost_analysis()
    return c.get("flops", 0.0), c.get("transcendentals", 0.0)


def _port(fn, *args):
    trace = OpTrace()
    with trace:
        fn(*args)
    return trace.flops, trace.transcendentals


def _vjp(f):
    return lambda x, g: jax.vjp(f, x)[1](g)[0]


X = (8, 16)
X3 = (4, 8, 64)

#: name -> (input shapes, torch function, jnp function)
CASES = {
    "add": ([X, X], torch.add, jnp.add),
    "sub": ([X, X], torch.sub, jnp.subtract),
    "mul": ([X, X], torch.mul, jnp.multiply),
    "div": ([X, X], torch.div, jnp.divide),
    "neg": ([X], torch.neg, jnp.negative),
    "maximum": ([X, X], torch.maximum, jnp.maximum),
    "broadcast add": ([X, (16,)], torch.add, jnp.add),
    "compare": ([X, X], torch.gt, jnp.greater),
    "where": ([X, X], lambda a, b: torch.where(a > 0, a, b),
              lambda a, b: jnp.where(a > 0, a, b)),
    "clamp": ([X], lambda a: torch.clamp(a, 0.0, 1.0),
              lambda a: jnp.clip(a, 0.0, 1.0)),
    "convert": ([X], lambda a: a.to(torch.float16),
                lambda a: a.astype(jnp.float16)),
    "reciprocal": ([X], torch.reciprocal, lambda a: 1 / a),
    "square": ([X], lambda a: a ** 2, lambda a: a ** 2),
    "cube": ([X], lambda a: a ** 3, lambda a: a ** 3),
    "inverse square": ([X], lambda a: a ** -2, lambda a: a ** -2),
    "sqrt power": ([X], lambda a: a ** 0.5, lambda a: a ** 0.5),
    "exp": ([X], torch.exp, jnp.exp),
    "log": ([X], torch.log, jnp.log),
    "rsqrt": ([X], torch.rsqrt, jax.lax.rsqrt),
    "tanh": ([X], torch.tanh, jnp.tanh),
    "sin": ([X], torch.sin, jnp.sin),
    "sigmoid": ([X], torch.sigmoid, jax.nn.sigmoid),
    "silu": ([X], F.silu, jax.nn.silu),
    "softplus": ([X], F.softplus, jax.nn.softplus),
    "gelu": ([X], lambda a: F.gelu(a, approximate="tanh"),
             lambda a: jax.nn.gelu(a, approximate=True)),
    "sum last": ([X], lambda a: a.sum(-1), lambda a: a.sum(-1)),
    "sum all": ([X], torch.sum, jnp.sum),
    "sum two dims": ([X3], lambda a: a.sum((-2, -1)),
                     lambda a: a.sum((-2, -1))),
    "mean last": ([X], lambda a: a.mean(-1), lambda a: a.mean(-1)),
    "mean all": ([X], torch.mean, jnp.mean),
    "amax": ([X3], lambda a: a.amax(1), lambda a: a.max(1)),
    "argmax": ([X], lambda a: a.argmax(-1), lambda a: a.argmax(-1)),
    "softmax": ([X3], lambda a: torch.softmax(a, -1),
                lambda a: jax.nn.softmax(a, -1)),
    "softmax middle": ([X3], lambda a: torch.softmax(a, 1),
                       lambda a: jax.nn.softmax(a, 1)),
    "logsumexp": ([X3], lambda a: torch.logsumexp(a, -1),
                  lambda a: jax.nn.logsumexp(a, -1)),
    "tril": ([(3, 16, 8)], torch.tril, jnp.tril),
    "sort": ([(8, 64)], lambda a: torch.sort(a, -1)[0],
             lambda a: jnp.sort(a, -1)),
    "silu backward": ([X, X], lambda x, g: torch.ops.aten.silu_backward(
        g, x), _vjp(jax.nn.silu)),
    "softplus backward": ([X, X],
                          lambda x, g: torch.ops.aten.softplus_backward(
                              g, x, 1.0, 20.0), _vjp(jax.nn.softplus)),
    "gelu backward": ([X, X], lambda x, g: torch.ops.aten.gelu_backward(
        g, x, approximate="tanh"), _vjp(jax.nn.gelu)),
    "softmax backward": ([X3, X3],
                         lambda y, g: torch.ops.aten._softmax_backward_data(
                             g, y, -1, torch.float32),
                         lambda y, g: y * (g - (g * y).sum(-1,
                                                           keepdims=True))),
    "transpose copy": ([X], lambda a: a.t().contiguous(),
                       lambda a: a.T + 0),
    "concatenate": ([X, X], lambda a, b: torch.cat([a, b], -1),
                    lambda a, b: jnp.concatenate([a, b], -1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_op_counts_what_xla_counts(name):
    shapes, port_fn, jax_fn = CASES[name]
    rng = np.random.default_rng(0)
    arrays = [np.abs(rng.standard_normal(s)).astype(np.float32) + 0.5
              for s in shapes]
    got = _port(port_fn, *[torch.from_numpy(a) for a in arrays])
    want = _xla(jax_fn, *arrays)
    assert got == want, (name, got, want)


@pytest.mark.parametrize("length", [2, 16, 17, 32, 48, 64, 256, 512])
def test_prefix_sums_count_what_xla_counts(length):
    """XLA's CPU prefix sum is a reduce window, rewritten into blocks of
    16 past that length."""
    a = np.ones((3, length), np.float32)
    assert _port(lambda t: torch.cumsum(t, -1), torch.from_numpy(a)) == \
        _xla(lambda t: jnp.cumsum(t, -1), a)
    assert _cumsum_flops(length) * 3 == _xla(
        lambda t: jnp.cumsum(t, -1), a)[0]


def test_products_keep_the_flop_counter_formulas():
    a, b = torch.ones(8, 16), torch.ones(16, 32)
    assert _port(torch.mm, a, b) == (2 * 8 * 16 * 32, 0)
    assert _port(torch.mm, a, b) == _xla(jnp.matmul, a.numpy(), b.numpy())


def test_views_count_nothing():
    a = torch.ones(8, 16)
    assert _port(lambda t: t.view(16, 8).t().unsqueeze(0).expand(2, 8, 16),
                 a) == (0, 0)
