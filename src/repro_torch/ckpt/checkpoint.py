"""Checkpointing: atomic, async, retention-managed.

The JAX package's on-disk format, so a checkpoint written by either
package restores in the other:

    <dir>/step_000123/
        manifest.json       # shapes, true dtypes, step, extra
        arrays.npz          # flat path -> ndarray

Paths are the JAX package's ``_flatten`` paths (dict keys sorted, ``#i``
for the items of a NamedTuple, tuple or list).  Leaves whose dtype numpy
lacks (bfloat16, float8) are stored widened to float32 — exact — and the
manifest keeps the true dtype, so a restore gives them back bit for bit.

Durability discipline:
  * writes go to ``step_XXXXXX.tmp`` then os.replace -> crash-safe (a torn
    write never shadows a good checkpoint);
  * ``latest_step`` scans for *complete* directories only (manifest present);
  * async mode hands the host copies to a writer thread so the train loop
    is not blocked by disk I/O.

``save`` copies each leaf to the host one at a time and widens it there,
so the card never holds a float32 copy of the tree.  A DTensor leaf is
stored as its global tensor (``full_tensor()``, a collective every rank
of its mesh joins), as the JAX package stores global arrays, and only
rank 0 of the default process group writes.  ``restore`` places each
leaf on ``device`` or, with a template, on the template leaf's device;
with ``shardings`` (a layout tree, ``repro_torch.dist.partition``) it
lays each leaf out on its mesh, so a checkpoint saved on one mesh
restores onto another.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

_STEP_RE = re.compile(r"^step_(\d{6,})$")
#: dtypes numpy has no type for: stored widened to float32
_WIDENED = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, (tuple, list)) or hasattr(tree, "_fields"):
        seq = tuple(tree)
        for i, v in enumerate(seq):
            out.update(_flatten(v, f"{prefix}/#{i}" if prefix else f"#{i}"))
        return out
    out[prefix or "value"] = tree
    return out


def _unflatten_into(template: Any, flat: Dict[str, Any], place,
                    prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, place,
                                   f"{prefix}/{k}" if prefix else k)
                for k in template}
    if hasattr(template, "_fields"):               # NamedTuple
        vals = [_unflatten_into(v, flat, place,
                                f"{prefix}/#{i}" if prefix else f"#{i}")
                for i, v in enumerate(tuple(template))]
        return type(template)(*vals)
    if isinstance(template, (tuple, list)):
        vals = [_unflatten_into(v, flat, place,
                                f"{prefix}/#{i}" if prefix else f"#{i}")
                for i, v in enumerate(template)]
        return type(template)(vals)
    return place(flat[prefix or "value"], template)


def _to_host(leaf: Any):
    """(numpy array to store, true dtype name) of one leaf: a host copy,
    never a view of a live tensor (an async write must not see the next
    step's update)."""
    if isinstance(leaf, torch.Tensor):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        host = leaf.detach().to("cpu", copy=True)
        name = str(host.dtype).removeprefix("torch.")
        if name in _WIDENED:
            host = host.float()
        return host.numpy(), name
    a = np.array(leaf, copy=True)
    name = str(a.dtype)
    if a.dtype.kind == "V" or name in _WIDENED:
        a = a.astype(np.float32)
    return a, name


def _from_host(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """A CPU tensor of the manifest's dtype from a stored array."""
    t = torch.from_numpy(np.asarray(a, order="C"))
    if dtype and str(t.dtype).removeprefix("torch.") != dtype:
        t = t.to(getattr(torch, dtype))              # bf16/fp8: exact
    return t


def _rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = False

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # -- inventory -----------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:06d}")

    # -- save -------------------------------------------------------------------
    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None,
             block: bool = True) -> None:
        """Checkpoint ``tree`` (nested dicts, NamedTuples, lists of
        tensors or arrays) at ``step``."""
        self.wait()                                   # one writer at a time
        # device -> host transfer happens here, leaf by leaf (the
        # synchronous part); disk I/O can then go async
        host, dtypes = {}, {}
        for k, v in _flatten(tree).items():
            host[k], dtypes[k] = _to_host(v)
        manifest = {
            "step": step,
            "time": time.time(),
            "arrays": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host.items()},
            "extra": extra or {},
        }

        def write():
            try:
                final = self._path(step)
                tmp = final + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"), **host)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f, indent=2)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)                # atomic publish
                self._gc()
            except Exception as e:  # noqa: BLE001
                self._error = e

        if _rank() != 0:
            return
        if self.async_save and not block:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()
        else:
            write()
            self._raise_pending()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def restore(self, step: Optional[int] = None, template: Any = None,
                device: "torch.device | str | None" = None,
                shardings: Any = None) -> Dict[str, Any]:
        """Load a checkpoint.

        Without ``template`` the tree is the flat ``{path: tensor}`` map;
        with one (a tree of tensors), each leaf takes the template leaf's
        place, dtype and device (``device``, when given, overrides the
        device; a template on the ``meta`` device restores to the CPU).
        ``shardings`` (a layout tree of the template's structure) then
        lays each leaf out on its mesh.  bfloat16 leaves come back bit for
        bit.
        Returns {"step", "tree", "extra"}.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _from_host(z[k], manifest["arrays"].get(k, {})
                                  .get("dtype"))
                    for k in z.files}
        if template is None:
            tree = (flat if device is None else
                    {k: v.to(device) for k, v in flat.items()})
        else:
            def place(t, like):
                if not isinstance(like, torch.Tensor):
                    return t if device is None else t.to(device)
                dev = device if device is not None else (
                    "cpu" if like.device.type == "meta" else like.device)
                return t.to(device=dev, dtype=like.dtype)
            tree = _unflatten_into(template, flat, place)
            if shardings is not None:
                from ..dist.partition import distribute
                tree = distribute(tree, shardings)
        return {"step": manifest["step"], "tree": tree,
                "extra": manifest.get("extra", {})}

    def verify(self, step: int) -> bool:
        """Integrity check: manifest arrays all present with right shapes."""
        path = self._path(step)
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as z:
                for k, meta in manifest["arrays"].items():
                    if k not in z.files:
                        return False
                    if list(z[k].shape) != meta["shape"]:
                        return False
            return True
        except Exception:  # noqa: BLE001
            return False
