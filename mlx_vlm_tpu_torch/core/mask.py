"""Attention-mask builders (boolean, True = attend).

Port of mlx_vlm_tpu/core/mask.py (causal_cache_mask :20).  Masks broadcast
against attention scores [B, H, S_q, C_kv].
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["causal_cache_mask"]


def causal_cache_mask(offset: Union[int, torch.Tensor], left_pad: torch.Tensor,
                      q_len: int, capacity: int) -> torch.Tensor:
    """Mask for queries at positions offset .. offset+q_len-1 against a
    left-aligned cache of `capacity` columns:
    keep(b, i, j) = left_pad[b] <= j <= offset[b] + i.
    Returns bool [B, 1, q_len, capacity].  `offset` is an int, a 0-dim
    int tensor (a cache's shared cursor, never read on the host) or an int
    tensor [B].  (The reference's sliding window is not ported.)"""
    dev = left_pad.device
    j = torch.arange(capacity, dtype=torch.int64, device=dev)[None, None, None, :]
    i = torch.arange(q_len, dtype=torch.int64, device=dev)[None, None, :, None]
    if isinstance(offset, torch.Tensor):
        qpos = offset.to(dev, torch.int64).reshape(-1, 1, 1, 1) + i
    else:
        qpos = int(offset) + i
    return (j <= qpos) & (j >= left_pad.to(torch.int64)[:, None, None, None])
