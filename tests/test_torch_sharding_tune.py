"""The port's sharding auto-tuner (``tune/sharding_autotune.py``): twins of
``tests/test_tune_sharding.py`` held against the JAX package's
``build_space`` and ``config_to_run_rules`` (the same names, values and
constraint outcomes), one real objective evaluation in a fake world, and
the tune -> record -> lookup path with a stand-in objective.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro.models.model import RunConfig as RefRunConfig  # noqa: E402
from repro.tune import build_space as ref_build_space  # noqa: E402
from repro.tune import config_to_run_rules as ref_translate  # noqa: E402

from repro_torch.core import H100_SXM, TuningCache  # noqa: E402
from repro_torch.core.registry import lookup_resolved  # noqa: E402
from repro_torch.models.model import RunConfig  # noqa: E402
from repro_torch.tune import (CellObjective, build_space,  # noqa: E402
                              config_to_run_rules, tune_cell)
from repro_torch.tune import sharding_autotune  # noqa: E402


def _same_space(args, kwargs, limit):
    """Both packages' spaces: the same names, values and feasible points
    (enumeration order included)."""
    sp, ref = build_space(*args, **kwargs), ref_build_space(*args, **kwargs)
    assert list(sp.names) == list(ref.names)
    for mine, theirs in zip(sp.parameters, ref.parameters):
        assert list(mine.values) == list(theirs.values), mine.name
    got, want = list(sp.enumerate(limit=limit)), list(ref.enumerate(
        limit=limit))
    assert got == want
    return sp, got


def test_train_space_has_train_knobs():
    sp, points = _same_space(("qwen2.5-32b", "train_4k"),
                             {"heads_divisible": False}, 500)
    assert {"REMAT", "MICROBATCH", "CE_CHUNK", "ACCUM_DTYPE",
            "ATTN_CHUNK", "ATTN_MODE", "SEQ_ATTN", "FSDP"} <= set(sp.names)
    # indivisible heads: no feasible expanded-mode config
    assert all(cfg["ATTN_MODE"] != "expanded" for cfg in points)


def test_decode_space_has_cache_layout():
    sp, _ = _same_space(("mistral-large-123b", "decode_32k"),
                        {"heads_divisible": True}, 100)
    assert "SEQ_KV" in sp.names
    assert "REMAT" not in sp.names          # no training knobs at decode


def test_moe_space_has_dispatch_impl():
    sp, _ = _same_space(("kimi-k2-1t-a32b", "train_4k"),
                        {"heads_divisible": True, "is_moe": True}, 200)
    assert "MOE_IMPL" in sp.names


def test_microbatch_divides_batch_constraint():
    _, points = _same_space(("granite-3-2b", "train_4k"),
                            {"heads_divisible": True}, 2000)
    assert all(256 % cfg["MICROBATCH"] == 0 for cfg in points)


def _translate_both(cfg):
    run, rules = config_to_run_rules(cfg, RunConfig())
    ref_run, ref_rules = ref_translate(cfg, RefRunConfig())
    assert dataclasses.asdict(run) == dataclasses.asdict(ref_run)
    assert rules == ref_rules
    return run, rules


def test_config_translation_roundtrip():
    cfg = {"REMAT": "dots", "MICROBATCH": 8, "CE_CHUNK": 512,
           "ACCUM_DTYPE": "bfloat16", "ATTN_CHUNK": 2048,
           "ATTN_MODE": "expanded", "SEQ_ATTN": "model",
           "FSDP": "pod_data", "MOE_IMPL": "gather"}
    run, rules = _translate_both(cfg)
    assert run.remat == "dots" and run.microbatch == 8
    assert run.ce_chunk == 512 and run.accum_dtype == "bfloat16"
    assert run.attn_chunk == 2048 and run.attn_mode == "expanded"
    assert run.moe_impl == "gather"
    assert rules["seq_attn"] == "model"
    assert rules["embed"] == ("pod", "data")


def test_fsdp_none_translates_to_unsharded_embed():
    _, rules = _translate_both({"FSDP": "none"})
    assert rules["embed"] is None


def test_cell_objective_evaluates_mamba2_decode_in_a_fake_world():
    """One roofline evaluation of the JAX package's own dry-run cell on
    the 16x16 production mesh (a fake world of 256 ranks; ``meta`` shards,
    no storage) at the H100 profile."""
    obj = CellObjective("mamba2-130m", "decode_32k", device_type="cpu")
    assert obj.profile is H100_SXM and obj.hbm_limit == H100_SXM.hbm_bytes
    space = build_space("mamba2-130m", "decode_32k", heads_divisible=True)
    config = {"FSDP": "pod_data", "SEQ_KV": None}
    assert set(config) == set(space.names)
    score = obj(config)
    assert math.isfinite(score) and score > 0, obj.log
    entry = obj.log[-1]
    assert entry["step_t"] == score
    assert score == max(entry["compute_t"], entry["memory_t"]) \
        + entry["collective_t"]


def test_cell_objective_runs_every_seq_kv_layout_of_an_attention_decode():
    """granite-3-2b decode_32k on the 16x16 mesh: the KV cache replicated
    along time, split over "model", and over ("data", "model") (batch
    takes "data" first, so the last is the second again).  The point the
    registry answers before any tuning (its heuristic) is one of them."""
    obj = CellObjective("granite-3-2b", "decode_32k", device_type="cpu")
    shape = {"arch": "granite-3-2b", "shape": "decode_32k",
             "multi_pod": False}
    heuristic = sharding_autotune._cell_heuristic(shape)
    assert heuristic == {"FSDP": "pod_data", "SEQ_KV": "model"}
    scores = {}
    for seq_kv in ("model", ("data", "model"), None):
        scores[seq_kv] = obj(dict(heuristic, SEQ_KV=seq_kv))
        assert math.isfinite(scores[seq_kv]) and scores[seq_kv] > 0, \
            obj.log[-1]
    assert scores["model"] == scores[("data", "model")], scores
    # a time-split cache reads 1/16 of it a rank
    assert scores["model"] < scores[None], scores


class _Stub(CellObjective):
    """A stand-in objective: a deterministic score per configuration."""

    def __call__(self, config):
        score = 1.0 + (0.5 if config.get("REMAT") == "full" else 0.0) \
            + 0.1 * config.get("MICROBATCH", 1) \
            + (0.2 if config.get("FSDP") == "none" else 0.0)
        self.log.append({"config": dict(config), "score": score})
        return score


def test_tune_cell_records_a_winner_that_lookup_resolves(tmp_path,
                                                         monkeypatch):
    key = ("granite-3-2b", "train_4k", False)
    monkeypatch.setitem(sharding_autotune._cell_objectives, key,
                        _Stub(*key))
    cache = TuningCache(str(tmp_path / "cache.json"))
    out = tune_cell("granite-3-2b", "train_4k", strategy="greedy", budget=6,
                    cache=cache)
    assert out["evaluations"] > 0 and math.isfinite(out["best_step_t"])
    shape = {"arch": "granite-3-2b", "shape": "train_4k",
             "multi_pod": False}
    res = lookup_resolved("sharding_cell", shape, profile=H100_SXM,
                          cache=cache)
    assert res.provenance == "exact"
    assert res.config == out["best_config"]
    run, rules = sharding_autotune.SHARDING_CELL(shape, res.config)()
    assert run.remat == res.config["REMAT"]
