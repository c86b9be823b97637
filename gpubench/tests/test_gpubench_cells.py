"""Each cell driven on the CPU at a small size, past the harness's look
for a card: a sound run is correct, and a run whose timed path is broken
underneath, once for each fault the cell can have, is not."""

import time

import pytest
import torch

from conftest import cell_names, tiny_files
from gpubench import harness

CELLS = cell_names()
MEASURED = [w["name"] for w in harness.spec()["workloads"]]


def drive(name, tmp_path, files, trace=False, seconds=0.3):
    return harness.run_cell(name, 2 ** 31 + 11, seconds, trace,
                            torch.device("cpu"), str(tmp_path),
                            time.perf_counter(), files=files)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, trace, tmp_path, tune_record):
    out = drive(name, tmp_path, tiny_files(name, "float32"), trace)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0
    assert out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    if not trace and name in MEASURED:
        assert "setup_s" in out["metrics"]
        assert len(out["metrics"]) == 2
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


# ---------------------------------------------------------------- faults

def _train_state_unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def update_(cfg, grads, state, params):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    monkeypatch.setattr(adamw, "update_", update_)


def _train_half_batch(monkeypatch):
    from repro_torch.dist import step
    loss_fn = step.loss_fn

    def half(cfg, params, batch, run=None, **kw):
        rows = next(iter(batch.values())).shape[0] // 2
        return loss_fn(cfg, params, {k: v[:rows] for k, v in batch.items()},
                       run, **kw)
    monkeypatch.setattr(step, "loss_fn", half)


def _train_grad_altered(monkeypatch):
    from repro_torch.optim import adamw
    update_ = adamw.update_

    def altered(cfg, grads, state, params):
        grads["blocks"]["attn"]["wq"] = grads["blocks"]["attn"]["wq"] * 2
        return update_(cfg, grads, state, params)
    monkeypatch.setattr(adamw, "update_", altered)


def _op(monkeypatch, change):
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.matmul import ops as mops
    for mod, name in ((mops, "matmul"), (fops, "flash_attention")):
        fn = getattr(mod, name)

        def broken(*a, _fn=fn, **kw):
            return change(_fn(*a, **kw))
        monkeypatch.setattr(mod, name, broken)


def _op_unwritten(out):
    return torch.zeros_like(out)


def _op_half_rows(out):
    out = out.clone()
    out[..., out.shape[-2] // 2:, :] = 0
    return out


def _op_row_altered(out):
    out = out.clone()
    out[..., 0, :] = out[..., out.shape[-2] // 2, :]
    return out


TRAIN_FAULTS = {"state_unchanged": _train_state_unchanged,
                "half_batch": _train_half_batch,
                "gradient_altered": _train_grad_altered}
OP_FAULTS = {"output_unwritten": _op_unwritten,
             "half_rows_left_out": _op_half_rows,
             "answer_altered": _op_row_altered}
CASES = ([(n, f) for n in CELLS if "train" in n for f in TRAIN_FAULTS]
         + [(n, f) for n in CELLS if "train" not in n for f in OP_FAULTS])


@pytest.mark.parametrize("name,fault", CASES)
def test_broken_timed_path_is_not_correct(name, fault, tmp_path, tune_record,
                                          monkeypatch):
    files = tiny_files(name, "float32")
    if fault in TRAIN_FAULTS:
        TRAIN_FAULTS[fault](monkeypatch)
    else:
        # the search measures the sound kernel; the window's calls break
        from gpubench import opstream
        warm = opstream.OpStream.warm_up

        def warm_then_break(self):
            warm(self)
            _op(monkeypatch, OP_FAULTS[fault])
            self.calls = [opstream.Call(c.tag, c.where, _rebind(c.fn),
                                        c.args, c.flops, c.nbytes)
                          for c in self.calls]
        monkeypatch.setattr(opstream.OpStream, "warm_up", warm_then_break)
    out = drive(name, tmp_path, files)
    assert out["correct"] is False, out["checks"]


def _rebind(fn):
    """The op the call names, looked up again (now the broken one)."""
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.matmul import ops as mops
    if getattr(fn, "__name__", "") == "matmul":
        return lambda *a: mops.matmul(*a)
    return lambda q, k, v: fops.flash_attention(q, k, v, causal=True)
