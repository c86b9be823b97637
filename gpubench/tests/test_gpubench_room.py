"""A new model's cell joins the benchmark with new files only.

In a copy of ``gpubench/`` and ``BENCHMARK.json`` a configuration, a cell
file, a driver (a toy training step over a parameter tree of its own),
a per-layer reader and their entries are added; the copy's own spec,
import, sound-run, fault and control tests then pass for the new cell,
run from the copy, and no file that the copy had is changed but
``BENCHMARK.json``, which only gains entries."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

from gpubench import harness

CONFIG = {"name": "toy-mlp", "source": "https://example.org/toy-mlp",
          "reduced": [], "width": 32, "hidden": 64, "torch_dtype": "bfloat16"}
CELL = {"driver": "toy_sgd",
        "traffic": {"rows": 4096, "lr": 0.1, "setup_steps": 3,
                    "trace_steps": 2},
        "limits": {"loss_gap": 1e-3, "grad_gap": 1e-3, "update_gap": 1e-3}}
DRIVER = '''"""A toy training step: a two-layer perceptron's SGD step over the
tree {"encoder": {"kernel"}, "decoder": {"kernel"}}, in the
configuration's type.  The reference is the same step in float32 through
functions of its own, which the planted faults leave alone."""

import functools
import sys
import time

import torch

from gpubench import checks, traffic
from gpubench.reference import precision


def _params(run, dtype):
    d, h = run.cfg["width"], run.cfg["hidden"]
    return {"encoder": {"kernel": traffic.normal(
                (d, h), d ** -0.5, dtype, run.device, run.seed, "encoder")},
            "decoder": {"kernel": traffic.normal(
                (h, 1), h ** -0.5, dtype, run.device, run.seed, "decoder")}}


def _data(run, dtype):
    n, d = run.traffic["rows"], run.cfg["width"]
    return (traffic.normal((n, d), 1.0, dtype, run.device, run.seed, "x"),
            traffic.normal((n, 1), 1.0, dtype, run.device, run.seed, "y"))


def loss_of(params, x, y, product=torch.matmul):
    h = torch.tanh(product(x, params["encoder"]["kernel"]))
    return (product(h, params["decoder"]["kernel"]) - y).square().mean()


def sgd(params, grads, lr):
    for k in params:
        params[k]["kernel"].sub_(lr * grads[k]["kernel"])


def _step(params, x, y, lr, loss, update):
    live = {k: {"kernel": v["kernel"].detach().requires_grad_(True)}
            for k, v in params.items()}
    value = loss(live, x, y)
    g = torch.autograd.grad(value, [live[k]["kernel"] for k in live])
    grads = {k: {"kernel": gk} for k, gk in zip(live, g)}
    update(params, grads, lr)
    return float(value), grads


# the program's loss and update: what the faults replace
def _loss(params, x, y):
    return loss_of(params, x, y)


def _update(params, grads, lr):
    sgd(params, grads, lr)


def _program_step(params, x, y, lr):
    return _step(params, x, y, lr, _loss, _update)


def _reference_step(product):
    return lambda params, x, y, lr: _step(
        params, x, y, lr, functools.partial(loss_of, product=product), sgd)


def _norms(tree):
    return {f"{k}/kernel": float(v["kernel"].double().norm())
            for k, v in tree.items()}


def _readings(run, dtype, step):
    params, (x, y) = _params(run, dtype), _data(run, dtype)
    losses = []
    for i in range(run.traffic["setup_steps"]):
        loss, grads = step(params, x, y, run.traffic["lr"])
        losses.append(loss)
        if i == 0:
            grad = _norms(grads)
    start = _params(run, dtype)
    change = _norms({k: {"kernel": params[k]["kernel"]
                         - start[k]["kernel"]} for k in params})
    return {"loss": losses, "grad": grad, "change": change}, params, (x, y)


def _gaps(got, ref):
    return {"loss_gap": checks.loss_gap(got["loss"], ref["loss"]),
            "grad_gap": checks.leaf_gap(got["grad"], ref["grad"]),
            "update_gap": checks.leaf_gap(got["change"], ref["change"])}


class Cell:
    def __init__(self, run):
        self.run = run
        dtype = getattr(torch, run.cfg["torch_dtype"])
        with run.phase("warm-up"):
            self.got, self.params, self.data = _readings(run, dtype,
                                                         _program_step)

    def window(self, deadline):
        step_s, t0 = [], time.perf_counter()
        now = t0
        while now < deadline:
            _program_step(self.params, *self.data, self.run.traffic["lr"])
            after = time.perf_counter()
            step_s.append(after - now)
            now = after
        elapsed = time.perf_counter() - t0
        return {"attempted": len(step_s), "step_s": step_s,
                "end_to_end": {"toy_steps_per_s": len(step_s) / elapsed}}

    def segment(self):
        for _ in range(self.run.traffic["trace_steps"]):
            _program_step(self.params, *self.data, self.run.traffic["lr"])

    def extra(self):
        pass

    def release(self):
        self.params = self.data = None

    def check(self):
        return _gaps(self.got, _readings(
            self.run, torch.float32, _reference_step(torch.matmul))[0])


def control(run, precision_name, fault=None):
    ref = _readings(run, torch.float32, _reference_step(torch.matmul))[0]
    other = _readings(run, torch.float32, _reference_step(
        precision.product(precision_name)))[0]
    return _gaps(other, ref)


def tiny(cfg, t):
    t.update(rows=256)
    return cfg, t


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(sys.modules[__name__], "_update",
                        lambda params, grads, lr: None)


def _half_batch(monkeypatch):
    def half(params, x, y):
        n = x.shape[0] // 2
        return loss_of(params, x[:n], y[:n])
    monkeypatch.setattr(sys.modules[__name__], "_loss", half)


def _gradient_altered(monkeypatch):
    def altered(params, grads, lr):
        grads["decoder"]["kernel"] = grads["decoder"]["kernel"] * 2
        sgd(params, grads, lr)
    monkeypatch.setattr(sys.modules[__name__], "_update", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "gradient_altered": _gradient_altered}
'''
READER = '''"""toy_step_ms: the median host ms of the window's steps."""

import statistics


def read(r):
    s = r.window.get("step_s")
    return statistics.median(s) * 1e3 if s else None
'''
ENTRIES = {
    "configs": {"name": "toy-mlp", "source": "https://example.org/toy-mlp",
                "file": "gpubench/configs/toy-mlp.json", "reduced": [],
                "why": "a toy perceptron over a parameter tree of its own"},
    "workloads": {"name": "toy-mlp.train", "config": "toy-mlp",
                  "traffic": "train", "chips": 1,
                  "why": "closed-loop SGD steps of 4096 rows: a driver the "
                         "tests have never seen"},
    "end_to_end": {"name": "toy_steps_per_s", "unit": "steps/s",
                   "better": "higher", "bound": 0.05, "source": "host_clock",
                   "workloads": ["toy-mlp.train"]},
    "per_layer": {"name": "toy_step_ms", "unit": "ms", "better": "lower",
                  "source": "host_clock", "layer": "train step",
                  "moves": "toy_steps_per_s",
                  "workloads": ["toy-mlp.train"]},
}
NEW = {"configs/toy-mlp.json": json.dumps(CONFIG),
       "workloads/toy-mlp.train.json": json.dumps(CELL),
       "drivers/toy_sgd.py": DRIVER,
       "metrics/toy_step_ms.py": READER}


def _digests(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_with_a_driver_of_its_own_needs_new_files_only(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("BENCHMARK.json", "PERF.md"):
        shutil.copy(os.path.join(harness.ROOT, name), tmp_path)
    before = _digests(tmp_path)
    for rel, text in NEW.items():
        (tmp_path / "gpubench" / rel).write_text(text)
    spec = harness.spec()
    for key, entry in ENTRIES.items():
        spec[key].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))

    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = os.path.join(harness.ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-k", "toy or spec or imports",
         "gpubench/tests/test_gpubench_spec.py",
         "gpubench/tests/test_gpubench_imports.py",
         "gpubench/tests/test_gpubench_cells.py",
         "gpubench/tests/test_gpubench_control.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-6000:] + out.stderr[-2000:]
    passed = re.findall(r"^(\S+) PASSED", out.stdout, re.M)
    toy = [t for t in passed if "toy" in t]
    for case in ("test_every_cell_resolves_to_its_files[toy-mlp.train]",
                 "test_every_driver_declares_its_cell_test_size_and_faults"
                 "[toy-mlp.train]",
                 "test_every_configuration_is_used_and_states_its_cuts"
                 "[toy-mlp]",
                 "test_every_per_layer_metric_has_its_reader[toy_step_ms]",
                 "test_sound_run_is_correct[False-toy-mlp.train]",
                 "test_sound_run_is_correct[True-toy-mlp.train]",
                 "test_broken_timed_path_is_not_correct"
                 "[toy-mlp.train-state_unchanged]",
                 "test_broken_timed_path_is_not_correct"
                 "[toy-mlp.train-half_batch]",
                 "test_broken_timed_path_is_not_correct"
                 "[toy-mlp.train-gradient_altered]",
                 "test_control_is_not_correct[toy-mlp.train]"):
        assert any(t.endswith("::" + case) for t in toy), case
    assert "test_readers_find_nothing_in_an_empty_run" in out.stdout

    after = _digests(tmp_path)
    changed = {p for p in before if after.get(p) != before[p]}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == {os.path.join("gpubench", p)
                                        for p in NEW}
    old = json.loads(open(os.path.join(harness.ROOT,
                                       "BENCHMARK.json")).read())
    new = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, value in old.items():
        if isinstance(value, list) and key != "paths" and key != "command":
            assert new[key][:len(value)] == value
        else:
            assert new[key] == value
