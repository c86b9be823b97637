"""Device profiles: the CUDA analogue of CLTune's per-device limits.

CLTune queries the OpenCL runtime for device limits (max workgroup size,
local-memory bytes, ...) and auto-imposes them as search-space constraints
(paper section III-A).  On a Hopper GPU the corresponding limits are the
opt-in shared memory one thread block may claim, the register file, the
SM count and the memory hierarchy.  A :class:`DeviceProfile` carries those
limits plus the peak compute / bandwidth numbers the analytical model needs.

:func:`device_profile` fills the limits from the device at run time
(``torch.cuda.get_device_properties``), the way CLTune queries OpenCL.
The datasheet constants in :data:`H100_SXM` are used only where the
runtime is silent (peak rates, memory bandwidth) and by CPU runs, which
model the H100 without one.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch

MiB = 1024**2


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Static description of one GPU."""

    name: str
    #: streaming multiprocessors
    sm_count: int
    #: shared memory one thread block may claim after opting in, bytes.
    #: This is the "local memory size" auto-constraint of the paper.
    smem_per_block_optin: int
    #: 32-bit registers per SM
    regs_per_sm: int
    #: L2 cache, bytes
    l2_bytes: int
    #: device memory (HBM) capacity, bytes
    hbm_bytes: int
    #: device memory bandwidth, bytes/s
    hbm_bw: float
    #: peak float32 rate of the FMA units (no tensor cores), FLOP/s
    peak_f32_flops: float
    #: peak dense bf16 tensor-core rate, FLOP/s
    peak_bf16_tensor_flops: float
    #: kernel launch fixed overhead, seconds (a model constant)
    launch_overhead: float = 4.0e-6
    #: threads one block may have: the "max workgroup size" of the paper,
    #: 1024 on every CUDA device since compute capability 2.0 (the runtime
    #: properties PyTorch exposes do not carry it)
    max_threads_per_block: int = 1024
    #: inter-GPU links one card drives and each link's rate in one
    #: direction, bytes/s (the twins of the JAX profiles' ``ici_links`` /
    #: ``ici_bw``): NVLink 4 on the H100 SXM is 18 links of 25 GB/s a
    #: direction, 450 GB/s — half the datasheet's 900 GB/s, which counts
    #: both directions.  The dry-run's collective term divides by their
    #: product; a collective that leaves the node (InfiniBand) is slower.
    link_count: int = 18
    link_bw: float = 25e9

    def fits_smem(self, nbytes: int) -> bool:
        """Whether a declared shared-memory footprint fits one block.

        A footprint exactly at the budget *fits* (the budget is usable
        bytes, not a strict bound)."""
        return nbytes <= self.smem_per_block_optin

    def fits_threads(self, threads: int) -> bool:
        """Whether a block of ``threads`` threads can be launched."""
        return threads <= self.max_threads_per_block


#: NVIDIA's H100 SXM datasheet and Hopper white paper (dense rates, 700 W)
H100_SXM = DeviceProfile(
    name="h100_sxm",
    sm_count=132,
    smem_per_block_optin=232_448,     # 227 KB
    regs_per_sm=65_536,
    l2_bytes=50 * MiB,
    hbm_bytes=80 * 10**9,
    hbm_bw=3.35e12,
    peak_f32_flops=67e12,
    peak_bf16_tensor_flops=989e12,
)

PROFILES: Dict[str, DeviceProfile] = {p.name: p for p in (H100_SXM,)}


def get_profile(name: str) -> DeviceProfile:
    try:
        return PROFILES[name]
    except KeyError as e:
        raise KeyError(
            f"unknown device profile {name!r}; known: {sorted(PROFILES)}"
        ) from e


def profile_name(device_name: str) -> str:
    """Cache/artifact key for a device name: ``h100_sxm`` for the SXM
    part (its name says HBM3 or SXM), else the name lower-cased with
    every run of other characters folded to ``_``."""
    if "H100" in device_name and ("SXM" in device_name
                                  or "HBM3" in device_name):
        return H100_SXM.name
    return re.sub(r"[^a-z0-9]+", "_", device_name.lower()).strip("_")


def device_profile(device: "torch.device | str | None" = None
                   ) -> DeviceProfile:
    """The profile of ``device`` (default: the current CUDA device).

    Limits come from ``torch.cuda.get_device_properties``; peak rates and
    bandwidth, which the runtime does not report, from :data:`H100_SXM`.
    A CPU device returns :data:`H100_SXM` itself: CPU runs model the H100.
    Asking for a CUDA device on a host without one raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return H100_SXM
    if dev.type != "cuda":
        raise ValueError(f"no device profile for device type {dev.type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device_profile: no CUDA device is available; pass an explicit "
            "profile (e.g. H100_SXM) or device='cpu' to model one")
    props = torch.cuda.get_device_properties(dev)

    def read(attr: str, default: int) -> int:
        value = getattr(props, attr, None)
        return int(value) if value else default

    return dataclasses.replace(
        H100_SXM,
        name=profile_name(props.name),
        sm_count=read("multi_processor_count", H100_SXM.sm_count),
        smem_per_block_optin=read("shared_memory_per_block_optin",
                                  H100_SXM.smem_per_block_optin),
        regs_per_sm=read("regs_per_multiprocessor", H100_SXM.regs_per_sm),
        l2_bytes=read("L2_cache_size", H100_SXM.l2_bytes),
        hbm_bytes=read("total_memory", H100_SXM.hbm_bytes))


def resolve_profile(profile: Optional[DeviceProfile],
                    device: "torch.device | str | None" = None
                    ) -> DeviceProfile:
    """``profile`` when given, else :func:`device_profile` of ``device``
    (the default CUDA device when that is None too)."""
    return profile if profile is not None else device_profile(device)
