"""Plain reference of a dense decoder's training step: forward, loss,
gradients and AdamW, in float32 (TF32 off).

It follows the port's equations (``repro_torch`` dense family), written
anew: RMSNorm, rotary embedding on split halves, grouped-query causal
attention with scores scaled by 1/sqrt(head_dim), a SwiGLU or tanh-GELU
MLP, pre-norm residuals, a final norm, the LM head (tied to the
embedding where the configuration ties it) and the mean token
cross-entropy.  The published model's multipliers are departures the
configuration file lists.  AdamW is decoupled weight decay with
global-norm clipping, bias corrections and a warm-up then cosine
schedule; parameters are kept in the configuration's type (bfloat16
matrices, float32 norm scales) and every update is computed in float32.

The parameter tree has the port's layout: ``embed`` (V, d),
``final_norm`` (d,), ``head`` (d, V) unless tied, and ``blocks`` stacked
over layers: ``ln1``/``ln2`` (L, d), ``attn/wq`` (L, d, H, hd),
``attn/wk``/``wv`` (L, d, KV, hd), ``attn/wo`` (L, H, hd, d),
``mlp/wi``/``wg`` (L, d, f) and ``mlp/wo`` (L, f, d).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import full_float32, held, product

_NEG = -1e30


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{'a/b': leaf} of a nested dict, keys sorted."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x: (B, S, heads, hd), position = index along S."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(cfg: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
           causal: torch.Tensor, mm, hold) -> torch.Tensor:
    """One pre-norm decoder layer on x (B, S, d)."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    KV, hd = cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg.get("rms_norm_eps", 1e-6), cfg.get("rope_theta", 1e4)
    B, S, _ = x.shape
    h = _rms_norm(x, w["ln1"], eps).reshape(B * S, d)
    q = mm(h, w["attn/wq"].reshape(d, H * hd)).reshape(B, S, H, hd)
    k = mm(h, w["attn/wk"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    v = mm(h, w["attn/wv"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    q, k = _rope(q, theta), _rope(k, theta)
    # query head h reads KV head h // (H / KV)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = mm(q.transpose(1, 2), k.transpose(1, 2).mT) * hd ** -0.5
    s = torch.where(causal, s, _NEG).softmax(-1)
    a = mm(s, v.transpose(1, 2)).transpose(1, 2).reshape(B * S, H * hd)
    x = hold(x + mm(a, w["attn/wo"].reshape(H * hd, d)).reshape(B, S, d))
    h = _rms_norm(x, w["ln2"], eps).reshape(B * S, d)
    up = mm(h, w["mlp/wi"])
    if "mlp/wg" in w:
        g = F.silu(mm(h, w["mlp/wg"])) * up
    else:
        g = F.gelu(up, approximate="tanh")
    return hold(x + mm(g, w["mlp/wo"]).reshape(B, S, d))


def loss(cfg: Dict, p: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Mean token cross-entropy; ``p`` is the flat {'blocks/attn/wq': ...}
    tree in float32.  ``precision`` below float32 rounds every product's
    operands and output and the residual stream (``precision.held``)."""
    mm, hold = product(precision), held(precision)
    d, eps = cfg["hidden_size"], cfg.get("rms_norm_eps", 1e-6)
    B, S = tokens.shape
    x = hold(p["embed"][tokens])
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["num_hidden_layers"]):
        w = {k[len("blocks/"):]: v[i] for k, v in p.items()
             if k.startswith("blocks/")}
        # each layer's activations are recomputed in the backward: the
        # float32 reference keeps only the layer inputs
        x = checkpoint(_layer, cfg, w, x, causal, mm, hold,
                       use_reentrant=False)
    hn = _rms_norm(x, p["final_norm"], eps).reshape(B * S, d)
    head = p["embed"].T if "head" not in p else p["head"]
    logits = mm(hn, head)
    return F.cross_entropy(logits, labels.reshape(-1).long())


def lr_at(opt: Dict, step: int) -> float:
    """Warm-up then cosine decay to ``min_lr_ratio`` of the peak."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    ratio = opt.get("min_lr_ratio", 0.1)
    return opt["lr"] * warm * (ratio + (1 - ratio) * 0.5
                               * (1 + math.cos(math.pi * t)))


ADAMW = {"betas": (0.9, 0.95), "eps": 1e-8, "weight_decay": 0.1,
         "clip_norm": 1.0, "min_lr_ratio": 0.1}


def train_readings(cfg: Dict, params: Dict[str, torch.Tensor],
                   batches: Sequence[Dict[str, torch.Tensor]], opt: Dict,
                   precision: str = "float32",
                   fault: Optional[str] = None) -> Dict[str, object]:
    """Run len(batches) steps from ``params`` (flat tree in the
    configuration's types; left as it was).  Returns each step's loss, each
    leaf's norm of the first step's gradient as AdamW takes it (after
    clipping), and each leaf's norm of its change over all the steps.

    ``fault`` plants a fault in this reference where it stands in for the
    program: ``"half_batch"`` (the loss over the first half of the rows)
    or ``"grad_double"`` (the attention query weights' gradient doubled).
    """
    full_float32()
    opt = {**ADAMW, **opt}
    b1, b2 = opt["betas"]
    # each update makes new tensors: ``params`` stays as it was
    stored = dict(params)
    m = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
    s2 = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
    losses: List[float] = []
    first: Dict[str, float] = {}
    for step, batch in enumerate(batches, start=1):
        live = {k: v.float().requires_grad_(True) for k, v in stored.items()}
        tokens, labels = batch["tokens"], batch["labels"]
        if fault == "half_batch":
            tokens, labels = tokens[: len(tokens) // 2], labels[: len(labels) // 2]
        value = loss(cfg, live, tokens, labels, precision)
        grads = dict(zip(live, torch.autograd.grad(value, list(live.values()))))
        del live
        if fault == "grad_double":
            grads["blocks/attn/wq"] = grads["blocks/attn/wq"] * 2
        losses.append(float(value.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = (opt["clip_norm"] / gnorm if gnorm > opt["clip_norm"]
                     else torch.ones_like(gnorm))
            lr = lr_at(opt, step)
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for k, g in grads.items():
                g = g * scale
                if step == 1:
                    first[k] = float(g.norm())
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                s2[k].mul_(b2).add_(g * g, alpha=1 - b2)
                p32 = stored[k].float()
                upd = (m[k] / c1) / (torch.sqrt(s2[k] / c2) + opt["eps"])
                stored[k] = (p32 - lr * (upd + opt["weight_decay"] * p32)
                             ).to(stored[k].dtype)
            del grads
    with torch.no_grad():
        change = {k: float((stored[k].float() - params[k].float()).norm())
                  for k in params}
    return {"loss": losses, "grad": first, "change": change}
