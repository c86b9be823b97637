"""The port's static analyzer (``repro_torch.analyze``) against the JAX
package's ``repro.analyze``, in one process.

The space audit and its findings are framework-free and must agree
exactly.  The resource rules are re-derived for CUDA: shared memory per
block (the JAX package's VMEM) and threads per block are proven, so the
same declaration with the same budget proves the same configs out, and a
search with the analyzer on prunes the same configs without building
them.
"""

import dataclasses
import json
import math
import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analyze as ref_an  # noqa: E402
import repro.core as ref_core  # noqa: E402
from repro.tune import tune_kernel as ref_tune  # noqa: E402
import repro_torch.analyze as port_an  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.analyze.__main__ import main as cli_main  # noqa: E402
from repro_torch.core import (H100_SXM, AnalyticalEvaluator,  # noqa: E402
                              KernelRegistry, TuningCache, lookup_resolved)
from repro_torch.kernels.attention import FLASH_ATTENTION  # noqa: E402
from repro_torch.kernels.conv2d import CONV2D  # noqa: E402
from repro_torch.kernels.matmul import GEMM, smem_footprint  # noqa: E402
from repro_torch.kernels.matmul import tuning_space  # noqa: E402
from repro_torch.tune import tune_kernel  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = H100_SXM.smem_per_block_optin
#: the JAX package's profile with the H100's name and one block's shared
#: memory as its VMEM budget: the same declaration proves the same configs
REF_H100 = dataclasses.replace(ref_core.TPU_V5E, name="h100_sxm",
                               vmem_bytes=BUDGET)


@pytest.fixture(autouse=True)
def _clear_analyze_env(monkeypatch):
    for knob in ("REPRO_ANALYZE", "REPRO_ANALYZE_STRICT", "REPRO_PREDICTOR"):
        monkeypatch.delenv(knob, raising=False)


# -- space audit: framework-free, verbatim --------------------------------------

def _audit_space(core, seed):
    """A space with dead values, a vacuous and an implied constraint and a
    raising one, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    a_vals = tuple(int(v) for v in sorted(rng.choice(64, 6, replace=False)))
    sp = core.SearchSpace()
    sp.add_parameter(name="A", values=a_vals)
    sp.add_parameter(name="B", values=(1, 2, 4, 8, 16))
    sp.add_parameter(name="C", values=("x", "y", "z"))
    sp.add_parameter(name="D", values=(False, True))
    sp.add_constraint(lambda a, b: a * b < 200, ("A", "B"), "budget")
    sp.add_constraint(lambda a, b: a * b < 400, ("A", "B"), "implied")
    sp.add_constraint(lambda c: c in "xyz", ("C",), "vacuous")
    sp.add_constraint(lambda b, d: b < 16 or not d, ("B", "D"), "dead")
    sp.add_constraint(lambda a, c: 1 // (a % 7) >= 0 or c == "x",
                      ("A", "C"), "raises on multiples of 7")
    return sp


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("exact_limit,samples", [(20_000, 2048), (40, 97)],
                         ids=["exact", "stratified"])
def test_audit_space_reports_equal(seed, exact_limit, samples):
    kw = dict(exact_limit=exact_limit, samples=samples, seed=seed)
    ref = ref_an.audit_space(_audit_space(ref_core, seed), **kw)
    port = port_an.audit_space(_audit_space(port_core, seed), **kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.confidence == ("exact" if exact_limit > 1000
                               else "probabilistic")
    shape = {"N": seed}
    assert [f.to_json() for f in port_an.space_findings(port, kernel="k",
                                                        shape=shape)] == \
        [f.to_json() for f in ref_an.space_findings(ref, kernel="k",
                                                    shape=shape)]


# -- resource proofs ------------------------------------------------------------

def _foot_kernel(core, values=(1, 2, 4, 8, 16, 32, 64), threads=None,
                 heuristic=None):
    """footprint = X * 8 KiB (X = 32 and 64 over one H100 block), with the
    matching analytical cliff; the same declaration in either package."""
    foot = (lambda s, cfg: cfg["X"] * 8192)

    def space(shape):
        sp = core.SearchSpace()
        sp.add_parameter(name="X", values=values)
        sp.add_constraint(lambda x: shape["N"] % x == 0, ("X",), "N % X")
        return sp

    def model(s, cfg, prof):
        budget = getattr(prof, "smem_per_block_optin", None) or \
            prof.vmem_bytes
        return math.inf if cfg["X"] * 8192 > budget else 1.0 / cfg["X"]

    kw = ({"smem_footprint": foot, "block_threads": threads}
          if core is port_core else {"vmem_footprint": foot})
    return core.tunable(
        name="afoot", space=space,
        heuristic=heuristic or (lambda s: {"X": 1}),
        analytical_model=model, register=False,
        registry=core.KernelRegistry(), **kw)(lambda s, c: (lambda: 0))


def test_the_proof_rejects_the_262144_byte_gemm_config():
    shape = {"M": 2048, "N": 2048, "K": 2048, "dtype": "float32"}
    cfg = dict(GEMM.heuristic(shape), BLOCK_M=128, BLOCK_N=128, BLOCK_K=64,
               PIPELINE_DEPTH=4)
    assert smem_footprint(cfg) == 4 * 4 * 64 * 256 == 262_144
    assert port_an.proven_violations(GEMM, shape, cfg, H100_SXM) == [
        "smem: declared footprint 262144 B > 232448 B on h100_sxm"]
    assert port_an.proven_violations(
        GEMM, shape, dict(cfg, PIPELINE_DEPTH=3), H100_SXM) == []
    # 512 x 256 blocks of 8 x 8 micro-tiles: 2048 threads
    wide = dict(cfg, BLOCK_M=512, BLOCK_N=256, BLOCK_K=8, PIPELINE_DEPTH=2)
    assert port_an.proven_violations(GEMM, shape, wide, H100_SXM) == [
        "threads: declared 2048 threads per block > 1024 on h100_sxm"]
    # the raw product of the extended space: what the space's own
    # constraints cut, the proof cuts too (its duplicates on an H100)
    params, _ = tuning_space(extended=True)
    space = port_core.SearchSpace()
    for name, values in params.items():
        space.add_parameter(name=name, values=values)
    check = port_an.proven_checker(GEMM, shape, H100_SXM)
    ext = GEMM.make_space(shape, extended=True)
    for c in space.sample_unique(random.Random(0), 400):
        if check(c):
            assert not ext.is_feasible(c)


def test_proofs_equal_the_jax_packages_at_the_same_budget():
    ref_k, port_k = _foot_kernel(ref_core), _foot_kernel(port_core)
    shape = {"N": 64}
    for x in (1, 16, 32, 64):
        ref_v = ref_an.proven_violations(ref_k, shape, {"X": x}, REF_H100)
        port_v = port_an.proven_violations(port_k, shape, {"X": x}, H100_SXM)
        assert bool(port_v) == bool(ref_v) == (x >= 32)
    (_, names, label), = port_an.device_constraints(port_k, shape, H100_SXM,
                                                   ("X",))
    assert label == f"analyze:smem<={BUDGET}B@h100_sxm" and names == ("X",)
    sp = port_k.make_space(shape)
    assert port_an.install_device_constraints(sp, port_k, shape,
                                              H100_SXM) == 1
    assert [c["X"] for c in sp.enumerate()] == [1, 2, 4, 8, 16]
    # a declared thread count proves too, and a raising model proves nothing
    threads = _foot_kernel(port_core, threads=lambda s, cfg: 128 * cfg["X"])
    assert port_an.proven_violations(threads, shape, {"X": 16},
                                     H100_SXM)[0].startswith("threads:")
    broken = _foot_kernel(port_core, threads=lambda s, cfg: 1 // 0)
    assert port_an.proven_violations(broken, shape, {"X": 64}, H100_SXM) == []


def _drive(core, kernel, evaluator, checker):
    """The engine over the kernel's space with no device constraint, so
    device feasibility is the checker's call."""
    shape = {"N": 64}
    spec = core.KernelSpec(
        name="drive", build=lambda cfg: (lambda: 0),
        analytical_model=lambda cfg, prof: kernel.analytical_model(
            shape, cfg, prof), meta=dict(shape))
    eng = core.EvaluationEngine(evaluator, spec, kernel.make_space(shape),
                                core.EngineConfig(proven_checker=checker))
    res = eng.run(core.make_strategy("full"), budget=None, seed=7)
    return res, res.extra["engine"]


def test_engine_proven_pruning_equals_the_jax_package():
    ref_k, port_k = _foot_kernel(ref_core), _foot_kernel(port_core)
    ref_res, ref_s = _drive(
        ref_core, ref_k,
        ref_core.TPUAnalyticalEvaluator(noise_sigma=0.0, profile=REF_H100),
        ref_an.proven_checker(ref_k, {"N": 64}, REF_H100))
    port_res, port_s = _drive(
        port_core, port_k, AnalyticalEvaluator(noise_sigma=0.0,
                                               profile=H100_SXM),
        port_an.proven_checker(port_k, {"N": 64}, H100_SXM))
    assert port_s["proven_pruned"] == ref_s["proven_pruned"] == 2
    assert port_s["compile_calls"] == ref_s["compile_calls"]
    assert [(t.config, t.time) for t in port_res.trials] == \
        [(t.config, t.time) for t in ref_res.trials]
    assert port_res.best_config == ref_res.best_config == {"X": 16}


@pytest.mark.parametrize("strategy,budget", [("full", None),
                                             ("annealing", 5)])
def test_search_with_the_analyzer_equals_the_jax_package(tmp_path, strategy,
                                                         budget):
    ref_k, port_k = _foot_kernel(ref_core), _foot_kernel(port_core)
    kw = dict(strategy=strategy, budget=budget, record=False, seed=3,
              warm_start=False, analyze=True)
    ref = ref_tune(ref_k, {"N": 64}, profile=REF_H100,
                   cache=ref_core.TuningCache(str(tmp_path / "r.json")), **kw)
    port = tune_kernel(port_k, {"N": 64}, profile=H100_SXM,
                       cache=TuningCache(str(tmp_path / "p.json")), **kw)
    assert port.analysis == ref.analysis
    assert port.analysis["proven_checker"] is True
    assert [(t.config, t.time) for t in port.result.trials] == \
        [(t.config, t.time) for t in ref.result.trials]
    assert port.engine_stats["proven_pruned"] == \
        ref.engine_stats["proven_pruned"]
    assert "proven checker on" in port.report()
    off = tune_kernel(port_k, {"N": 64}, profile=H100_SXM,
                      cache=TuningCache(str(tmp_path / "p.json")),
                      **dict(kw, analyze=False))
    assert off.analysis is None
    assert [(t.config, t.time) for t in off.result.trials] == \
        [(t.config, t.time) for t in port.result.trials]


def test_env_knobs_drive_the_analyzer(tmp_path, monkeypatch):
    port_k = _foot_kernel(port_core)
    kw = dict(strategy="full", profile=H100_SXM, record=False,
              cache=TuningCache(str(tmp_path / "p.json")))
    assert tune_kernel(port_k, {"N": 64}, **kw).analysis is None
    monkeypatch.setenv("REPRO_ANALYZE", "1")
    assert tune_kernel(port_k, {"N": 64}, **kw).analysis is not None
    monkeypatch.setenv("REPRO_ANALYZE", "2")
    with pytest.raises(TypeError, match="REPRO_ANALYZE"):
        tune_kernel(port_k, {"N": 64}, **kw)
    # strict: an error finding (an unsatisfiable space) raises before
    # any search, in both packages
    for core, tuner_cls, ev in (
            (ref_core, ref_core.Tuner,
             ref_core.TPUAnalyticalEvaluator(noise_sigma=0.0)),
            (port_core, port_core.Tuner,
             AnalyticalEvaluator(noise_sigma=0.0, profile=H100_SXM))):
        t = tuner_cls(evaluator=ev, profile=(H100_SXM if core is port_core
                                             else REF_H100))
        t.add_kernel(lambda cfg: (lambda: 0), name="broken",
                     analytical_model=lambda cfg, prof: 1.0)
        t.add_parameter("X", [1, 2])
        t.add_constraint(lambda x: x > 5, ["X"], "nothing fits")
        monkeypatch.setenv("REPRO_ANALYZE", "1")
        monkeypatch.setenv("REPRO_ANALYZE_STRICT", "1")
        with pytest.raises(ValueError, match="REPRO_ANALYZE_STRICT"):
            t.tune(strategy="full")
        monkeypatch.setenv("REPRO_ANALYZE_STRICT", "0")
        assert t.tune(strategy="full").best_config is None


def test_transfer_refuses_a_config_the_proof_rules_out(tmp_path):
    """A config tuned where it fitted is not served where it provably
    does not: the lookup falls through to the heuristic."""
    port_k = _foot_kernel(port_core)
    cache = TuningCache(str(tmp_path / "c.json"))
    cache.record("afoot", port_k.key_for({"N": 64}), "h100_sxm", {"X": 16},
                 1e-3, "full", 4, shape={"N": 64})
    res = lookup_resolved(port_k, {"N": 128}, profile=H100_SXM, cache=cache,
                          policy="transfer")
    assert res.provenance == "transfer" and res.config == {"X": 16}
    # a card of the same name with less shared memory: 131072 B > 100000
    small = dataclasses.replace(H100_SXM, smem_per_block_optin=100_000)
    res = lookup_resolved(port_k, {"N": 128}, profile=small, cache=cache,
                          policy="transfer")
    assert res.provenance == "heuristic" and res.config == {"X": 1}


# -- lint and the CLI -------------------------------------------------------------

def test_the_port_registry_lints_without_errors():
    report = port_an.analyze_registry(profiles=[H100_SXM])
    assert report.errors == []
    # the builtins: the three CUDA kernels and, as in the JAX package's
    # registry, the sharding tuner's cell
    assert {f.kernel for f in report} == {"gemm", "conv2d",
                                          "flash_attention", "sharding_cell"}
    assert report.exit_code() == 0
    # with no card, the default sweep is the built-in profiles
    assert port_an.default_profiles() == [H100_SXM]


def test_lint_rules_equal_the_jax_packages_with_smem_names():
    """Over-budget heuristics and spaces give the JAX package's findings,
    VMEM renamed to shared memory."""
    def findings(an, core, profile, values, heur):
        k = _foot_kernel(core, values=values, heuristic=lambda s: heur)
        out = an.kernel_findings(k, shapes=[{"N": 64}], profiles=[profile])
        return [(f.rule_id.replace("vmem", "smem"), f.severity,
                 json.dumps(f.data).replace("vmem", "smem"))
                for f in out if not f.rule_id.startswith("align")]

    for values, heur in (((32, 64), {"X": 32}), ((1, 64), {"X": 64}),
                         ((1, 2, 64), {"X": 1})):
        ref = findings(ref_an, ref_core, REF_H100, values, heur)
        port = findings(port_an, port_core, H100_SXM, values, heur)
        assert port == ref
        assert port
    rules = {r for r, _, _ in findings(port_an, port_core, H100_SXM,
                                       (32, 64), {"X": 32})}
    assert {"space-over-smem", "heuristic-over-smem"} <= rules


def test_advisories_are_info_only():
    k = _foot_kernel(port_core, threads=lambda s, cfg: 48)
    fs = port_an.alignment_findings(k, {"N": 64}, {"X": 1, "BLOCK_W": 6},
                                    H100_SXM)
    assert {(f.rule_id, f.severity) for f in fs} == {("align-warp", "info"),
                                                     ("align-vector", "info")}
    flash = {"Sq": 4096, "Sk": 4096, "D": 128, "causal": True}
    big = {"BLOCK_Q": 256, "BLOCK_K": 256, "PIPELINE_DEPTH": 2}
    fs = port_an.register_findings(FLASH_ATTENTION, flash, big, H100_SXM)
    assert [(f.rule_id, f.severity) for f in fs] == [("register-estimate",
                                                      "info")]
    assert port_an.proven_violations(FLASH_ATTENTION, flash, big,
                                     H100_SXM)   # shared memory, not regs
    conv = {"H": 4096, "W": 4096, "Fh": 3, "Fw": 3}
    assert port_an.register_findings(CONV2D, conv, CONV2D.heuristic(conv),
                                     H100_SXM) == []


def test_cli_exit_codes_and_json(capsys):
    assert cli_main(["--profile", "h100_sxm", "--quiet"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["counts"]["error"] == 0 and report["findings"]
    assert cli_main(["--profile", "tpu_v5e"]) == 2
    assert cli_main(["--kernel", "nope"]) == 2
    capsys.readouterr()
    # the flash space has dead values (warnings): --strict fails on them
    assert cli_main(["--strict", "--quiet", "--kernel",
                     "flash_attention"]) == 1
    capsys.readouterr()
    broken = KernelRegistry()
    k = port_core.tunable(
        name="over", space=lambda s: _foot_kernel(
            port_core, values=(32, 64)).make_space(s),
        heuristic=lambda s: {"X": 32}, register=True, registry=broken,
        smem_footprint=lambda s, cfg: cfg["X"] * 8192,
        default_shapes=({"N": 64},))(lambda s, c: None)
    assert k.name == "over"
    assert cli_main(["--quiet"], registry=broken) == 1
    report = json.loads(capsys.readouterr().out)
    assert "space-over-smem" in {f["rule_id"] for f in report["findings"]}


def test_cli_module_runs(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analyze", "--profile",
         "h100_sxm", "--json", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(out.read_text())["counts"]["error"] == 0
    assert "finding(s)" in proc.stderr
