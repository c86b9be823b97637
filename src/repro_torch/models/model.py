"""Decoder assembly: param trees, forward, loss, decode — all families.

The layer stack keeps the JAX package's stacked ``(L, ...)`` parameters
and runs a Python loop over their layers where JAX has ``lax.scan``
(heterogeneous stacks — MoE leading dense layers, Zamba2 super-blocks
around one weight-shared attention block — are segmented as there).
``RunConfig`` carries the execution knobs of the JAX package field for
field, so derived configs and memo keys match; ``scan_blocks`` changes no
value here.  ``remat`` wraps each layer body in
``torch.utils.checkpoint`` (where JAX has ``jax.checkpoint``): ``"full"``
saves nothing inside the body, ``"dots"`` saves the weight projections'
outputs (``aten.mm``: every projection is a matmul of an activation with
a weight matrix, the products JAX's ``dots_with_no_batch_dims_saveable``
keeps) and recomputes the rest, attention's batched score and value
products (``aten.bmm``) among them.  The loss (``loss_fn``) reads the
MoE families' ``mtp`` tree for DeepSeek-style multi-token prediction.

The JAX models' ``shard()`` annotations stand at the same places, with
the same logical axes (``repro_torch.dist.sharding``): outside a mesh
scope they return their argument; inside one the trees are DTensors and
the annotations lay the activations out.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..dist.sharding import (_is_dtensor, embed_rows, grad_as_input,
                             logsumexp_last, matmul, per_batch, relayout,
                             replicate, reshape, shard, take_last)
from .config import ModelConfig
from .layers import (_proj, apply_attention, apply_mlp, attention_cache_defs,
                     attention_defs, effective_chunk, mlp_defs, norm_defs,
                     rms_norm)
from .mla import apply_mla, mla_cache_defs, mla_defs
from .moe import apply_moe, moe_defs
from .params import (ParamDef, abstract_params, init_params, stack_defs,
                     torch_dtype)
from .ssm import apply_mamba, mamba_defs, mamba_state_defs

_REMAT = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs (a point in the sharding tuner's space)."""

    remat: str = "none"              # none | full | dots
    moe_impl: str = "scatter"        # scatter | onehot
    attn_chunk: int = 0              # 0 = unchunked; else KV chunk length
    #: attention layout: grouped | expanded (see layers.apply_attention)
    attn_mode: str = "grouped"
    scan_blocks: bool = True         # scan over layers vs unroll (JAX only)
    microbatch: int = 1              # gradient-accumulation splits
    #: gradient-accumulation dtype (training)
    accum_dtype: str = "float32"
    #: sequence-chunked cross-entropy (training)
    ce_chunk: int = 0
    #: vocab-chunked LM head: the (d, V) head matmul is issued as V/chunk
    #: column tiles (the serve path derives this from the tuned gemm
    #: BLOCK_N, so a hot-swapped winner changes the step).  0 = one
    #: whole-vocab product; ignored unless it divides the vocab exactly.
    head_chunk: int = 0

    def remat_policy(self) -> Optional[str]:
        """The recomputation policy's name (None for ``"none"``); unknown
        names raise, as in the JAX package."""
        if self.remat not in _REMAT:
            raise ValueError(f"unknown remat {self.remat!r}")
        return None if self.remat == "none" else self.remat

    def eager_step(self, seq_len: int, kind: str) -> "RunConfig":
        """These knobs as the eager step of a ``kind`` step at ``seq_len``
        reads them: ``scan_blocks`` set (it changes nothing here), and a
        chunk that does not split the sequence (:func:`effective_chunk`)
        or an attention chunk in a decode step (which attends over its
        cache unchunked) set to 0.  Two configs whose eager steps are
        equal run the same operations."""
        attn = 0 if kind == "decode" else effective_chunk(self.attn_chunk,
                                                          seq_len)
        return dataclasses.replace(
            self, scan_blocks=True, attn_chunk=attn,
            ce_chunk=effective_chunk(self.ce_chunk, seq_len))


DEFAULT_RUN = RunConfig()


def _save_projections(ctx, op, *args, **kwargs):
    """``"dots"``: keep what a weight projection computes (``aten.mm``: a
    matmul of folded activations with a 2-D weight, no batch dimension),
    recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(run: RunConfig, body: Callable) -> Callable:
    """``body(p, x)`` under the run's recomputation policy: its activations
    are dropped after the forward pass and recomputed in the backward one
    (``"dots"`` keeps the projections').  Without autograd it is ``body``.

    The saved input ``x`` is laid out as sequence-parallel attention lays
    its positions out (``"seq_attn"``): where the rules map it to mesh
    axes, each rank keeps only its slice of the sequence (a local slice)
    and the body gathers it where it needs the whole sequence, as the JAX
    compile saves and gathers a layer input there; elsewhere ``x`` stays
    as it is."""
    policy = run.remat_policy()
    if policy is None:
        return body
    context = (functools.partial(create_selective_checkpoint_contexts,
                                 _save_projections)
               if policy == "dots" else None)

    def wrapped(p, x):
        if not torch.is_grad_enabled():
            return body(p, x)
        x = relayout(x, "batch", "seq_attn", "embed")
        if context is None:
            return checkpoint(body, p, x, use_reentrant=False)
        return checkpoint(body, p, x, use_reentrant=False,
                          context_fn=context)

    return wrapped


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _attn_block_defs(cfg: ModelConfig, ffn: str) -> Dict[str, Any]:
    d = cfg.d_model
    block: Dict[str, Any] = {"ln1": norm_defs(d), "ln2": norm_defs(d)}
    block["attn"] = mla_defs(cfg) if cfg.use_mla else attention_defs(cfg)
    if ffn == "dense":
        block["mlp"] = mlp_defs(cfg)
    elif ffn == "moe":
        block["moe"] = moe_defs(cfg)
    else:
        raise ValueError(ffn)
    return block


def _mamba_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": norm_defs(cfg.d_model), "mamba": mamba_defs(cfg)}


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, d), ("vocab", "embed"), init="normal",
                          scale=0.02),
        "final_norm": norm_defs(d),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, V), ("embed", "vocab"))

    if cfg.family == "ssm":
        defs["blocks"] = stack_defs(_mamba_block_defs(cfg), cfg.num_layers)
    elif cfg.family == "hybrid":
        n_mamba, n_attn, _ = cfg.layer_plan()
        per = cfg.hybrid_mamba_per_attn
        rem = n_mamba - n_attn * per
        defs["super_mambas"] = stack_defs(
            stack_defs(_mamba_block_defs(cfg), per), n_attn)
        defs["shared_attn"] = _attn_block_defs(cfg, "dense")   # weight-shared
        if rem:
            defs["tail_mambas"] = stack_defs(_mamba_block_defs(cfg), rem)
    elif cfg.is_moe:
        n_dense = cfg.moe_first_dense
        if n_dense:
            defs["dense_blocks"] = stack_defs(
                _attn_block_defs(cfg, "dense"), n_dense)
        defs["moe_blocks"] = stack_defs(_attn_block_defs(cfg, "moe"),
                                        cfg.num_layers - n_dense)
        if cfg.mtp_depth:
            # read only by the multi-token-prediction loss (training)
            defs["mtp"] = {
                "proj": ParamDef((2 * d, d), (None, "embed")),
                "block": _attn_block_defs(cfg, "moe"),
                "norm": norm_defs(d),
            }
    else:  # dense / vlm / audio
        defs["blocks"] = stack_defs(_attn_block_defs(cfg, "dense"),
                                    cfg.num_layers)
    return defs


def init_model(cfg: ModelConfig,
               generator: "torch.Generator | int | None" = 0,
               device: "torch.device | str | None" = None):
    """Random weights on ``device`` (default: the card) from a
    ``torch.Generator`` or a seed."""
    return init_params(model_defs(cfg), generator, cfg.param_dtype, device)


def abstract_model(cfg: ModelConfig):
    return abstract_params(model_defs(cfg), cfg.param_dtype)


def _unbind(stacked: Any) -> List[Any]:
    """Per-layer views of a stacked ``(L, ...)`` tree, one unbind a leaf."""
    if isinstance(stacked, torch.Tensor):
        return list(stacked.unbind(0))
    per = {k: _unbind(v) for k, v in stacked.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _as_input(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return grad_as_input(tree)
    return {k: _as_input(v) for k, v in tree.items()}


def _layers(stacked: Any) -> Iterator[Any]:
    """Per-layer views of a stacked ``(L, ...)`` tree, one unbind a leaf.
    On a mesh each view's gradient is laid out as the view as the
    backward reaches it (``grad_as_input``): a layer's gradient is reduced
    to its shard there, as GSPMD reduces it, and never waits, whole, for
    the other layers' in the stacked gradient.  Each layer's views take
    that layout as the layer's turn comes: the autograd engine runs the
    node made last first, so nodes made for every layer before the first
    ran would reduce no layer's gradient before the backward ended, each
    layer's whole one held until then (6.2 GiB of qwen2.5-32b
    ``train_4k``'s peak)."""
    for p in _unbind(stacked):
        yield _as_input(p)


def _stack(trees: List[Any]) -> Any:
    """The stacked ``(L, ...)`` tree of per-layer trees (new tensors)."""
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees, dim=0)
    return {k: _stack([t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, run: RunConfig, p, x, positions,
                ffn: str, cache=None, cache_pos=None):
    """Returns (x, aux_loss, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, new_cache = apply_mla(cfg, p["attn"], h, positions,
                                 cache=cache, cache_pos=cache_pos)
    else:
        a, new_cache = apply_attention(cfg, p["attn"], h, positions,
                                       cache=cache, cache_pos=cache_pos,
                                       attn_chunk=run.attn_chunk,
                                       mode=run.attn_mode)
    x = x + a
    # the feed-forward input whole along the sequence: gathered once here
    # where the residual stream holds sequence shards (``_remat``)
    h = relayout(rms_norm(x, p["ln2"], cfg.norm_eps), "batch", "seq",
                 "embed")
    if ffn == "dense":
        out = apply_mlp(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        out, aux = apply_moe(cfg, p["moe"], h, impl=run.moe_impl)
    return x + out, aux, new_cache


def _mamba_block(cfg: ModelConfig, p, x, state=None):
    h = relayout(rms_norm(x, p["ln"], cfg.norm_eps), "batch", "seq", "embed")
    m, new_state = apply_mamba(cfg, p["mamba"], h, state=state)
    return x + m, new_state


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params, batch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.input_mode == "embeddings":
        x = batch["embeds"].to(torch_dtype(cfg.param_dtype))
    else:
        x = embed_rows(params["embed"], batch["tokens"])
    x = shard(x, "batch", "seq", "embed")
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    return x, positions


def _head_logits(cfg: ModelConfig, params, x_normed,
                 run: RunConfig = DEFAULT_RUN) -> torch.Tensor:
    head = (grad_as_input(params["embed"]).T if cfg.tie_embeddings
            else params["head"])
    V = cfg.vocab_size
    hc = int(run.head_chunk)
    if 0 < hc < V and V % hc == 0:
        # column-tiled head: the same values as the single product, issued
        # as V / hc products of the tuned tile width
        logits = torch.cat([torch.matmul(x_normed, head[:, i:i + hc])
                            for i in range(0, V, hc)], dim=-1)
    elif _is_dtensor(head):            # in GSPMD's layout
        B, S, d = x_normed.shape
        logits = reshape(matmul(reshape(x_normed, (B * S, d)), head),
                         (B, S, V))
    else:
        logits = torch.matmul(x_normed, head)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return shard(logits, "batch", "seq", "vocab")


def _logits(cfg: ModelConfig, params, x,
            run: RunConfig = DEFAULT_RUN) -> torch.Tensor:
    return _head_logits(cfg, params,
                        rms_norm(x, params["final_norm"], cfg.norm_eps), run)


def _forward_mambas(cfg: ModelConfig, run: RunConfig, stacked, x):
    def body(p, x):
        return _mamba_block(cfg, p, x)[0]
    body = _remat(run, body)
    for p in _layers(stacked):
        x = body(p, x)
    return x


def _forward_attns(cfg: ModelConfig, run: RunConfig, stacked, x, positions,
                   ffn: str):
    """(x, the stack's aux losses summed from zero, as ``lax.scan`` sums
    them)."""
    def body(p, x):
        x, a, _ = _attn_block(cfg, run, p, x, positions, ffn)
        return x, a
    body = _remat(run, body)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in _layers(stacked):
        x, a = body(p, x)
        aux = aux + a
    return x, aux


def forward_hidden(cfg: ModelConfig, params, batch,
                   run: RunConfig = DEFAULT_RUN
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward up to (but excluding) the LM head.

    Returns (hidden (B,S,d) after final norm, aux_loss scalar: the MoE
    layers' load-balance losses summed)."""
    run.remat_policy()
    x, positions = embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family == "ssm":
        x = _forward_mambas(cfg, run, params["blocks"], x)
    elif cfg.family == "hybrid":
        def super_body(pm, x):
            x = _forward_mambas(cfg, run, pm, x)
            x, a, _ = _attn_block(cfg, run, params["shared_attn"], x,
                                  positions, "dense")
            return x, a
        super_body = _remat(run, super_body)
        aux1 = torch.zeros((), dtype=torch.float32, device=x.device)
        for pm in _layers(params["super_mambas"]):
            x, a = super_body(pm, x)
            aux1 = aux1 + a
        aux = aux + aux1
        if "tail_mambas" in params:
            x = _forward_mambas(cfg, run, params["tail_mambas"], x)
    elif cfg.is_moe:
        if "dense_blocks" in params:
            x, a = _forward_attns(cfg, run, params["dense_blocks"], x,
                                  positions, "dense")
            aux = aux + a
        x, a = _forward_attns(cfg, run, params["moe_blocks"], x,
                              positions, "moe")
        aux = aux + a
    else:
        x, a = _forward_attns(cfg, run, params["blocks"], x, positions,
                              "dense")
        aux = aux + a
    return relayout(rms_norm(x, params["final_norm"], cfg.norm_eps),
                    "batch", "seq", "embed"), aux


def forward(cfg: ModelConfig, params, batch,
            run: RunConfig = DEFAULT_RUN
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B,S,V), aux_loss scalar)."""
    x, aux = forward_hidden(cfg, params, batch, run)
    return _head_logits(cfg, params, x, run), aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in float32 (over ``mask``'s weight when given)."""
    lf = logits.float()
    lse = logsumexp_last(lf)
    gold = take_last(lf, labels)
    nll = lse - gold
    if mask is not None:
        return replicate((nll * mask).sum()) / torch.clamp(
            replicate(mask.sum()), min=1.0)
    return replicate(nll.mean())


def _chunk_nll(cfg: ModelConfig, params, h, labels, mask):
    """(summed masked NLL, mask weight) of one sequence chunk."""
    logits = _head_logits(cfg, params, h).float()
    lse = logsumexp_last(logits)
    gold = take_last(logits, labels)
    return replicate(((lse - gold) * mask).sum()), replicate(mask.sum())


def _ce_from_hidden(cfg: ModelConfig, params, hidden, labels, mask,
                    ce_chunk: int) -> torch.Tensor:
    """Cross entropy from post-norm hidden states.

    ``ce_chunk > 0``: sequence-chunked — each (B, chunk, V) logits block is
    built inside ``torch.utils.checkpoint`` and recomputed in the backward
    pass, so peak memory never holds the full (B, S, V) logits.  No
    chunking when ``ce_chunk`` does not divide S or S <= ce_chunk.
    """
    S = hidden.shape[1]
    if not effective_chunk(ce_chunk, S):
        logits = _head_logits(cfg, params, hidden)
        return cross_entropy(logits, labels, mask)

    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, ce_chunk):
        sl = slice(i, i + ce_chunk)
        m = (mask[:, sl] if mask is not None else
             torch.ones(labels[:, sl].shape, dtype=torch.float32,
                        device=hidden.device))
        s, c = checkpoint(functools.partial(_chunk_nll, cfg, params),
                          hidden[:, sl], labels[:, sl], m,
                          use_reentrant=False)
        nll_sum, count = nll_sum + s, count + c
    return nll_sum / torch.clamp(count, min=1.0)


def loss_fn(cfg: ModelConfig, params, batch,
            run: RunConfig = DEFAULT_RUN, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics): ``ce``, ``aux``, ``loss`` and, with the MoE
    families' multi-token prediction, ``mtp``."""
    hidden, aux = forward_hidden(cfg, params, batch, run)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    loss = _ce_from_hidden(cfg, params, hidden, labels, mask, run.ce_chunk)
    metrics = {"ce": loss, "aux": aux}
    total = loss + aux_weight * aux

    if cfg.mtp_depth and "mtp" in params and cfg.input_mode == "tokens":
        # DeepSeek-style multi-token prediction: one extra block predicts
        # token t+2 from [h_t ; embed(label_t)]
        x, positions = embed_inputs(cfg, params, batch)
        emb_next = shard(embed_rows(params["embed"], labels), "batch", "seq",
                         "embed")
        h = _proj(torch.cat([x, emb_next], dim=-1), params["mtp"]["proj"], 1)
        h, _, _ = _attn_block(cfg, run, params["mtp"]["block"], h,
                              positions, "moe")
        h = rms_norm(h, params["mtp"]["norm"], cfg.norm_eps)
        mtp_labels = per_batch(lambda t: torch.roll(t, -1, dims=-1), labels)
        mtp_mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        mtp_mask[:, -1] = 0.0
        mtp_loss = _ce_from_hidden(cfg, params, h, mtp_labels, mtp_mask,
                                   run.ce_chunk)
        metrics["mtp"] = mtp_loss
        total = total + cfg.mtp_loss_weight * mtp_loss

    metrics["loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return {"blocks": stack_defs(mamba_state_defs(cfg, batch),
                                     cfg.num_layers)}
    if cfg.family == "hybrid":
        n_mamba, n_attn, _ = cfg.layer_plan()
        per = cfg.hybrid_mamba_per_attn
        rem = n_mamba - n_attn * per
        out = {
            "super_mambas": stack_defs(
                stack_defs(mamba_state_defs(cfg, batch), per), n_attn),
            "attn": stack_defs(
                attention_cache_defs(cfg, batch, max_len), n_attn),
        }
        if rem:
            out["tail_mambas"] = stack_defs(
                mamba_state_defs(cfg, batch), rem)
        return out
    one = (mla_cache_defs(cfg, batch, max_len) if cfg.use_mla
           else attention_cache_defs(cfg, batch, max_len))
    if cfg.is_moe:
        out = {"moe_blocks": stack_defs(
            one, cfg.num_layers - cfg.moe_first_dense)}
        if cfg.moe_first_dense:
            out["dense_blocks"] = stack_defs(one, cfg.moe_first_dense)
        return out
    return {"blocks": stack_defs(one, cfg.num_layers)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "torch.device | str | None" = None):
    """A zero decode cache (KV, latent and SSM state) on ``device``
    (default: the card)."""
    return init_params(cache_defs(cfg, batch, max_len), 0, cfg.param_dtype,
                       device)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    return abstract_params(cache_defs(cfg, batch, max_len), cfg.param_dtype)


def _decode_attns(cfg: ModelConfig, run: RunConfig, stacked, cache, x,
                  positions, pos: int, ffn: str):
    """Decode through a stack of attention blocks; their caches are
    written in place."""
    for p, c in zip(_layers(stacked), _layers(cache)):
        x, _, _ = _attn_block(cfg, run, p, x, positions, ffn, cache=c,
                              cache_pos=pos)
    return x


def _decode_mambas(cfg: ModelConfig, stacked, state, x):
    """Decode through a stack of Mamba blocks; returns (x, new stacked
    state), the given state left as it was."""
    new = []
    for p, s in zip(_layers(stacked), _layers(state)):
        x, ns = _mamba_block(cfg, p, x, state=s)
        new.append(ns)
    return x, _stack(new)


def decode_step(cfg: ModelConfig, params, cache, tokens_or_embeds,
                pos: int, run: RunConfig = DEFAULT_RUN
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step.  tokens: (B, 1) int (or (B, 1, d) embeds);
    pos: the current position.  Returns (logits (B, V), new cache).

    KV and latent caches are updated in place (a write at the same
    position is idempotent); SSM states come back as new tensors and the
    ones in ``cache`` stay as they were.  So a second call on the same
    inputs gives the same answer."""
    if cfg.input_mode == "embeddings":
        x = tokens_or_embeds.to(torch_dtype(cfg.param_dtype))
    else:
        x = shard(embed_rows(params["embed"], tokens_or_embeds), "batch",
                  "seq", "embed")
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    new_cache: Dict[str, Any] = {}

    if cfg.family == "ssm":
        x, new_cache["blocks"] = _decode_mambas(cfg, params["blocks"],
                                                cache["blocks"], x)
    elif cfg.family == "hybrid":
        new_super = []
        for pm, sm, ca in zip(_layers(params["super_mambas"]),
                              _layers(cache["super_mambas"]),
                              _layers(cache["attn"])):
            x, ns = _decode_mambas(cfg, pm, sm, x)
            x, _, _ = _attn_block(cfg, run, params["shared_attn"], x,
                                  positions, "dense", cache=ca,
                                  cache_pos=pos)
            new_super.append(ns)
        new_cache["super_mambas"] = _stack(new_super)
        new_cache["attn"] = cache["attn"]
        if "tail_mambas" in params:
            x, new_cache["tail_mambas"] = _decode_mambas(
                cfg, params["tail_mambas"], cache["tail_mambas"], x)
    else:
        stacks = ([("dense_blocks", "dense"), ("moe_blocks", "moe")]
                  if cfg.is_moe else [("blocks", "dense")])
        for name, ffn in stacks:
            if name in params:
                x = _decode_attns(cfg, run, params[name], cache[name], x,
                                  positions, pos, ffn)
                new_cache[name] = cache[name]
    logits = _logits(cfg, params, x, run)[:, 0]
    return logits, new_cache
