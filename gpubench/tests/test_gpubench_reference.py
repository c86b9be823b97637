"""The plain references against the port's CPU path at a small size, in
float32: the dense decoder's loss, gradients and AdamW step, and the op
cells' product and attention.  The weights' layout is the port's."""

import pytest
import torch

from conftest import driver_of
from gpubench import traffic
from gpubench.reference import dense_lm, ops
from gpubench.traffic import TINY_LM

#: the driver of the cells this reference serves
DRIVER = driver_of("granite-3-2b.train")

CFG = dict(TINY_LM, name="tiny", hidden_act="silu", torch_dtype="float32",
           rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False)


@pytest.mark.parametrize("act,tied", [("silu", False), ("silu", True),
                                      ("gelu_pytorch_tanh", False)])
def test_weights_have_the_ports_layout(act, tied):
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import tree_paths
    cfg = dict(CFG, hidden_act=act, tie_word_embeddings=tied)
    ours = {p: s for p, (s, _, _) in traffic.dense_lm_specs(cfg).items()}
    ports = {p: d.shape for p, d in
             tree_paths(model_defs(DRIVER.model_config(cfg))).items()}
    assert ours == ports


@pytest.mark.parametrize("act,tied", [("silu", False), ("silu", True),
                                      ("gelu_pytorch_tanh", False)])
def test_loss_and_gradients_match_the_port(act, tied):
    from repro_torch.models.model import loss_fn
    cfg = dict(CFG, hidden_act=act, tie_word_embeddings=tied)
    flat = traffic.dense_lm(cfg, 5, "cpu")
    batch = traffic.zipf_batches(5, 1, 3, 12, cfg["vocab_size"], 1.1)[0]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    live = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    ref = dense_lm.loss(cfg, live, tb["tokens"], tb["labels"])
    ref_g = torch.autograd.grad(ref, list(live.values()))
    port = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, _ = loss_fn(DRIVER.model_config(cfg), traffic.nest(port), tb)
    port_g = torch.autograd.grad(loss, list(port.values()))
    assert float(loss.detach()) == pytest.approx(float(ref.detach()), rel=1e-5)
    for a, b in zip(port_g, ref_g):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6 * b.abs().max())


def test_adamw_step_matches_the_port():
    from repro_torch.optim import adamw
    flat = traffic.dense_lm(CFG, 6, "cpu")
    grads = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(
        i)) for i, (k, v) in enumerate(flat.items())}
    opt = {"lr": 3e-4, "warmup_steps": 2, "total_steps": 20}
    cfg = adamw.OptimConfig(**opt)
    state = adamw.init(cfg, traffic.nest(flat))
    new, _, m = adamw.update(cfg, traffic.nest(grads), state,
                             traffic.nest(flat))
    got = dense_lm.flatten(new)
    # the reference's update, read through its change after one step with
    # these gradients standing in for autograd's
    fake = dict(dense_lm.ADAMW, **opt)
    gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = fake["clip_norm"] / gnorm if gnorm > fake["clip_norm"] else 1.0
    lr = dense_lm.lr_at(fake, 1)
    b1, b2 = fake["betas"]
    for k, p in flat.items():
        g = grads[k] * scale
        upd = ((1 - b1) * g / (1 - b1)) / (torch.sqrt(
            (1 - b2) * g * g / (1 - b2)) + fake["eps"])
        want = p - lr * (upd + fake["weight_decay"] * p)
        assert torch.allclose(got[k], want, rtol=1e-6, atol=1e-9), k
    assert float(m["lr"]) == pytest.approx(lr, rel=1e-6)


def test_train_readings_follow_the_port_through_three_steps():
    """The reference's readings equal the port trainer's at float32."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.dist.step import make_train_step
    from repro_torch.models.model import RunConfig
    opt = {"lr": 3e-4, "warmup_steps": 2, "total_steps": 20}
    flat = traffic.dense_lm(CFG, 7, "cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in traffic.zipf_batches(7, 3, 4, 16, CFG["vocab_size"],
                                             1.1)]
    ref = dense_lm.train_readings(CFG, flat, batches, opt)
    cfg = adamw.OptimConfig(**opt)
    params = traffic.nest({k: v.clone() for k, v in flat.items()})
    state = adamw.init(cfg, params)
    step = make_train_step(DRIVER.model_config(CFG), RunConfig(), cfg)
    losses = []
    for i, b in enumerate(batches):
        params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = [float(t.norm()) / (1 - cfg.betas[0])
                     for t in tree_leaves(state.m)]
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    assert first == pytest.approx(list(ref["grad"].values()), rel=1e-4)
    change = [float((a.detach() - b).norm()) for a, b in
              zip(tree_leaves(params), flat.values())]
    assert change == pytest.approx(list(ref["change"].values()), rel=1e-3)


def test_product_matches_the_ports_plain_gemm():
    from repro_torch.kernels.matmul.matmul import gemm_plain
    from repro_torch.kernels.matmul.ops import heuristic_config
    a = traffic.normal((64, 96), 1.0, torch.float32, "cpu", 1, "a")
    b = traffic.normal((96, 32), 1.0, torch.float32, "cpu", 1, "b")
    want = gemm_plain(a, b, heuristic_config(64, 32, 96))
    assert torch.allclose(ops.matmul(a, b), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_the_ports_oracle(causal):
    from repro_torch.kernels.attention.ref import attention_reference
    q, k, v = (traffic.normal((6, 64, 32), 1.0, torch.float32, "cpu", 2, n)
               for n in "qkv")
    got = ops.attention(q, k, v, causal=causal, heads_per_block=4)
    want = attention_reference(q, k, v, causal=causal)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
