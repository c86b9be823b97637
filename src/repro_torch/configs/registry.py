"""Architecture registry: ``--arch <id>`` resolution.

Each architecture module exports FULL (exact published config), SMOKE
(reduced same-family config for CPU tests), SKIP_SHAPES and NOTES.  The
modules are loaded from this package (``repro_torch.configs.*``), so every
config is the port's own :class:`~repro_torch.models.config.ModelConfig`.
``input_specs`` gives the model inputs of one cell as ``meta`` tensors
(shapes and dtypes, no storage): the dry-run's batch.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Set

import torch

from ..models.config import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "qwen2.5-32b": "qwen2_5_32b",
    "granite-34b": "granite_34b",
    "granite-3-2b": "granite_3_2b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llava-next-34b": "llava_next_34b",
    "zamba2-7b": "zamba2_7b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-130m": "mamba2_130m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    full: ModelConfig
    smoke: ModelConfig
    skip_shapes: Set[str]
    notes: str


def _load(arch_id: str):
    try:
        mod = _ARCH_MODULES[arch_id]
    except KeyError as e:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}") from e
    return importlib.import_module(f"{__package__}.{mod}")


def get_arch(arch_id: str) -> ArchSpec:
    m = _load(arch_id)
    return ArchSpec(arch_id=arch_id, full=m.FULL, smoke=m.SMOKE,
                    skip_shapes=set(m.SKIP_SHAPES), notes=m.NOTES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    spec = get_arch(arch_id)
    return spec.smoke if smoke else spec.full


def all_cells(include_skipped: bool = False):
    """Every (arch_id, shape_name) cell of the assignment (40 total)."""
    for arch_id in ARCH_IDS:
        spec = get_arch(arch_id)
        for shape_name in SHAPES:
            skipped = shape_name in spec.skip_shapes
            if skipped and not include_skipped:
                continue
            yield arch_id, shape_name, skipped


def input_specs(cfg: ModelConfig, shape: "ShapeConfig | str",
                with_labels: bool = True) -> Dict[str, Any]:
    """``meta`` tensors standing in for the model inputs of one cell.

    train/prefill: {'tokens' or 'embeds', 'labels'} at (global_batch, seq);
    decode: one new token (B, 1) — the cache/pos specs come from
    ``cache_defs`` since they depend on the mesh.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    f = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if shape.kind == "decode":
        if cfg.input_mode == "embeddings":
            return {"inputs": f((B, 1, cfg.d_model), torch.bfloat16)}
        return {"inputs": f((B, 1), torch.int32)}
    out: Dict[str, Any] = {}
    if cfg.input_mode == "embeddings":
        out["embeds"] = f((B, S, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = f((B, S), torch.int32)
    if with_labels and shape.kind == "train":
        out["labels"] = f((B, S), torch.int32)
    return out


# ---------------------------------------------------------------------------
# the paper's own case-study configurations (conv images, GEMM sizes)
# ---------------------------------------------------------------------------

#: paper section V: 8192x4096 image, filters 3x3 / 7x7 / 11x11
PAPER_CONV = {"image": (8192, 4096), "filters": ((3, 3), (7, 7), (11, 11))}
#: paper section VI: square M = N = K = 2048 single-precision GEMM
PAPER_GEMM = {"M": 2048, "N": 2048, "K": 2048}
#: paper budgets: conv explored 1/32 of 3424 = 107; GEMM 1/2048 of 241600 = 117
PAPER_BUDGETS = {"conv": 107, "gemm": 117, "runs": 128}
