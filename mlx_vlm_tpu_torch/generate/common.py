"""Shared generation types and helpers.

Port of mlx_vlm_tpu/generate/common.py (round_up :16, GenerationResult :30).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def device_peak_memory_gb(device) -> float:
    """Peak memory allocated by torch on a CUDA device, in GiB (0.0 on CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / (1024**3)


@dataclasses.dataclass
class GenerationResult:
    """Per-chunk streaming result."""

    text: str
    token: Optional[int]
    logprobs: Any
    prompt_tokens: int
    generation_tokens: int
    prompt_tps: float
    generation_tps: float
    peak_memory: float
    finish_reason: Optional[str] = None
    total_tokens: int = 0

    def __post_init__(self):
        self.total_tokens = self.prompt_tokens + self.generation_tokens
