"""Parity of the port's search space and strategies with the JAX package.

Both packages get the same space, seed and objective; they must agree on
enumeration order, sampling sequences, config keys and every strategy's
trial sequence.  Everything runs in one process.
"""

import math
import random

import pytest

pytest.importorskip("torch")

from repro.core import space as ref_space  # noqa: E402
from repro.core import strategies as ref_strategies  # noqa: E402
from repro_torch.core import space as port_space  # noqa: E402
from repro_torch.core import strategies as port_strategies  # noqa: E402


def _space(mod):
    sp = mod.SearchSpace()
    sp.add_parameter(name="BM", values=(16, 32, 64, 128))
    sp.add_parameter(name="BK", values=(8, 16, 32))
    sp.add_parameter(name="ORDER", values=("mn", "nm"))
    sp.add_parameter(name="FLAG", values=(False, True))
    sp.add_parameter(name="STEPS", values=(1, 2, 4))
    sp.add_constraint(lambda bk, s: bk % s == 0, ("BK", "STEPS"),
                      "BK divisible by STEPS")
    sp.add_constraint(lambda bm, flag: not (flag and bm == 128),
                      ("BM", "FLAG"), "no flag at 128")
    return sp


def _objective(cfg):
    """Plain-Python cost with a valley and an infeasible corner."""
    if cfg["BM"] == 16 and cfg["BK"] == 32:
        return math.inf
    return (1.0 + abs(math.log2(cfg["BM"]) - 5.5)
            + 0.3 * abs(math.log2(cfg["BK"]) - 4)
            + (0.2 if cfg["ORDER"] == "nm" else 0.0)
            + (0.05 * cfg["STEPS"]) - (0.1 if cfg["FLAG"] else 0.0))


def test_enumeration_order_matches():
    ref, port = _space(ref_space), _space(port_space)
    assert port.enumerate() == ref.enumerate()
    assert port.cardinality() == ref.cardinality()
    assert port.size() == ref.size()


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_sequences_match(seed):
    ref, port = _space(ref_space), _space(port_space)
    r_rng, p_rng = random.Random(seed), random.Random(seed)
    assert ([port.sample(p_rng) for _ in range(20)]
            == [ref.sample(r_rng) for _ in range(20)])
    assert (port.sample_unique(random.Random(seed), 12)
            == ref.sample_unique(random.Random(seed), 12))


def test_config_key_matches_including_bool_vs_int():
    ref, port = _space(ref_space), _space(port_space)
    for cfg in ref.enumerate():
        assert port.config_key(cfg) == ref.config_key(cfg)
    # True and 1 hash alike in Python; the key must still tell them apart
    sp_r, sp_p = ref_space.SearchSpace(), port_space.SearchSpace()
    sp_r.add_parameter(name="X", values=(1, True))
    sp_p.add_parameter(name="X", values=(1, True))
    for v in (1, True):
        assert sp_p.config_key({"X": v}) == sp_r.config_key({"X": v})
    assert sp_p.config_key({"X": 1}) != sp_p.config_key({"X": True})


@pytest.mark.parametrize("name,kwargs,budget", [
    ("full", {}, None),
    ("full", {"offset": 1, "stride": 3}, None),
    ("random", {}, 25),
    ("annealing", {}, 30),
    ("pso", {}, 30),
    ("greedy", {}, 30),
    ("evolutionary", {}, 30),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_strategy_trial_sequences_match(name, kwargs, budget, seed):
    ref, port = _space(ref_space), _space(port_space)
    r = ref_strategies.make_strategy(name, **kwargs).run(
        ref, _objective, budget, seed=seed)
    p = port_strategies.make_strategy(name, **kwargs).run(
        port, _objective, budget, seed=seed)
    assert [(t.config, t.time) for t in p.trials] == \
        [(t.config, t.time) for t in r.trials]
    assert p.best_config == r.best_config
    assert p.evaluations == r.evaluations


def test_ask_tell_drivers_match():
    ref, port = _space(ref_space), _space(port_space)
    seeds = [{"BM": 32, "BK": 16, "ORDER": "mn", "FLAG": True, "STEPS": 2}]
    for name in ("pso", "evolutionary", "random", "annealing"):
        out = []
        for mod, sp in ((ref_strategies, ref), (port_strategies, port)):
            drv = mod.make_strategy(name).asktell(sp, 24, seed=1, seeds=seeds)
            asked = []
            while True:
                batch = drv.ask()
                if not batch:
                    break
                asked.append(batch)
                drv.tell([(c, _objective(c)) for c in batch])
            asked.append(drv.result().best_config)
            drv.close()
            out.append(asked)
        assert out[1] == out[0], name
