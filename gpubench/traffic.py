"""The one generator every cell's traffic file feeds: seeded weights,
token batches and op inputs.  The same seed gives the same tensors, on
the card or on the CPU, and every tensor is drawn on its device in one
call (a leaf, a stacked set of layers, an input set).

Each tensor has a generator of its own, seeded from the run's seed and
the tensor's name, so that one can be drawn again alone (the reference
draws the weights again after the program has changed them in place).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch


#: a small dense decoder of the configurations' shape: the size at which
#: the CPU tests run the dense cells (each driver's ``tiny``)
TINY_LM = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128,
               vocab_size=97)


def _stream_seed(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def normal(shape, std: float, dtype: torch.dtype, device, seed: int,
           name: str) -> torch.Tensor:
    """N(0, std^2) of ``shape`` in ``dtype`` on ``device``, drawn from the
    stream (seed, name)."""
    g = torch.Generator(device=device)
    g.manual_seed(_stream_seed(seed, name))
    x = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return x.mul_(std) if std != 1.0 else x


def dense_lm_specs(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """{path: (shape, dtype name, std)} of a dense decoder in the port's
    layout; std 0 marks a norm scale (ones).  Projections are drawn with
    std 1/sqrt(contracted width), the embedding with 0.02."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, ff, V = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]
    wt = cfg["torch_dtype"]
    specs = {
        "embed": ((V, d), wt, 0.02),
        "final_norm": ((d,), "float32", 0.0),
        "blocks/ln1": ((L, d), "float32", 0.0),
        "blocks/ln2": ((L, d), "float32", 0.0),
        "blocks/attn/wq": ((L, d, H, hd), wt, d ** -0.5),
        "blocks/attn/wk": ((L, d, KV, hd), wt, d ** -0.5),
        "blocks/attn/wv": ((L, d, KV, hd), wt, d ** -0.5),
        "blocks/attn/wo": ((L, H, hd, d), wt, (H * hd) ** -0.5),
        "blocks/mlp/wi": ((L, d, ff), wt, d ** -0.5),
        "blocks/mlp/wo": ((L, ff, d), wt, ff ** -0.5),
    }
    if cfg["hidden_act"] == "silu":
        specs["blocks/mlp/wg"] = ((L, d, ff), wt, d ** -0.5)
    if not cfg.get("tie_word_embeddings", False):
        specs["head"] = ((d, V), wt, d ** -0.5)
    return dict(sorted(specs.items()))


def dense_lm_leaf(cfg: Dict, path: str, seed: int, device) -> torch.Tensor:
    shape, dt, std = dense_lm_specs(cfg)[path]
    dtype = getattr(torch, dt)
    if std == 0.0:
        return torch.ones(shape, dtype=dtype, device=device)
    return normal(shape, std, dtype, device, seed, "weights/" + path)


def dense_lm(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The flat {path: tensor} weights of a dense decoder."""
    return {p: dense_lm_leaf(cfg, p, seed, device)
            for p in dense_lm_specs(cfg)}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{'a/b': x} -> {'a': {'b': x}}."""
    root: Dict = {}
    for path, v in flat.items():
        node = root
        *head, last = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v
    return root


def zipf_batches(seed: int, n: int, batch: int, seq: int, vocab: int,
                 a: float) -> List[Dict[str, np.ndarray]]:
    """``n`` batches of ``batch`` rows of ``seq`` int32 token ids with
    next-token labels.  Ids are Zipf-distributed over the vocabulary
    (rank r drawn with weight r^-a, ranks mapped to ids by a seeded
    permutation); every row of every batch differs from every other."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 0x7A1F])
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -a
    ids = rng.permutation(vocab).astype(np.int32)
    rows = ids[rng.choice(vocab, size=(n * batch, seq + 1), p=w / w.sum())]
    if len({r.tobytes() for r in rows}) != len(rows):
        raise ValueError("the seed drew two equal rows; rows must differ")
    rows = rows.reshape(n, batch, seq + 1)
    return [{"tokens": np.ascontiguousarray(r[:, :-1]),
             "labels": np.ascontiguousarray(r[:, 1:])} for r in rows]


def stacked_weights(K: int, N: int, layers: int, dtype, device, seed: int,
                    name: str) -> torch.Tensor:
    """(layers, K, N) projection weights, std 1/sqrt(K)."""
    return normal((layers, K, N), 1 / math.sqrt(K), dtype, device, seed,
                  "weights/" + name)
