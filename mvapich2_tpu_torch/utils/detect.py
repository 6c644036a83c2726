"""Platform detection for the port (counterpart of the JAX package's
``utils/detect.py``): the card's name, SM count, memory and peak memory
bandwidth, from ``torch.cuda.get_device_properties``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class PlatformInfo:
    platform: str          # "gpu" | "cpu"
    device_kind: str       # torch.cuda.get_device_name, e.g. "NVIDIA H100 80GB HBM3"
    num_devices: int
    sm_count: int
    memory_bytes: int
    hbm_bw_gbps: float     # published peak device-memory rate, GB/s (0: unknown)


# Published peak device-memory bandwidth (GB/s) by card name, most
# specific substring first (NVIDIA data sheets). The SXM part's name
# carries no "SXM": torch reports it as "NVIDIA H100 80GB HBM3".
_HBM_GBPS = (
    ("H100 NVL", 3900.0),
    ("H100 PCIe", 2000.0),
    ("H100", 3350.0),
    ("H200", 4800.0),
)


def lookup_hbm_gbps(name: str) -> float:
    """Peak memory bandwidth of the card named ``name``; 0.0 when the
    table does not know it."""
    for key, gbps in _HBM_GBPS:
        if key in name:
            return gbps
    return 0.0


def detect(device: Optional[torch.device] = None) -> PlatformInfo:
    """Describe CUDA device ``device`` (default: the current one), or the
    CPU when no CUDA device is present."""
    if not torch.cuda.is_available():
        return PlatformInfo("cpu", "cpu", 0, 0, 0, 0.0)
    props = torch.cuda.get_device_properties(device)
    return PlatformInfo(platform="gpu", device_kind=props.name,
                        num_devices=torch.cuda.device_count(),
                        sm_count=props.multi_processor_count,
                        memory_bytes=props.total_memory,
                        hbm_bw_gbps=lookup_hbm_gbps(props.name))


def arch_key() -> str:
    """Tuning-table key: ``gpu:<name>:<count>``."""
    info = detect()
    return f"{info.platform}:{info.device_kind}:{info.num_devices}"
