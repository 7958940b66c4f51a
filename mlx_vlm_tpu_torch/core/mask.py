"""Attention-mask builders (boolean, True = attend).

Port of mlx_vlm_tpu/core/mask.py (causal_cache_mask :20, full_valid_mask
:58).  Masks broadcast against attention scores [B, H, S_q, C_kv].  A
cursor is an int, a 0-dim int tensor (a cache's shared cursor) or an int
tensor [B] (per-row cursors); a tensor is never read on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["causal_cache_mask", "full_valid_mask"]


def _cursor(offset: Union[int, torch.Tensor], dev) -> Union[int, torch.Tensor]:
    """An int cursor as it is; a tensor cursor as int64 [B or 1, 1] on
    `dev`."""
    if isinstance(offset, torch.Tensor):
        return offset.to(dev, torch.int64).reshape(-1, 1)
    return int(offset)


def causal_cache_mask(offset: Union[int, torch.Tensor], left_pad: torch.Tensor,
                      q_len: int, capacity: int,
                      window: Optional[int] = None) -> torch.Tensor:
    """Mask for queries at positions offset .. offset+q_len-1 against a
    left-aligned cache of `capacity` columns:
    keep(b, i, j) = left_pad[b] <= j <= offset[b] + i, and with a sliding
    `window` also j > offset[b] + i - window.
    Returns bool [B, 1, q_len, capacity]."""
    dev = left_pad.device
    j = torch.arange(capacity, dtype=torch.int64, device=dev)[None, None, None, :]
    i = torch.arange(q_len, dtype=torch.int64, device=dev)[None, None, :, None]
    off = _cursor(offset, dev)
    qpos = (off.reshape(-1, 1, 1, 1) if isinstance(off, torch.Tensor)
            else off) + i
    keep = (j <= qpos) & (j >= left_pad.to(torch.int64)[:, None, None, None])
    if window is not None:
        keep &= j > qpos - window
    return keep


def full_valid_mask(left_pad: torch.Tensor, total: Union[int, torch.Tensor],
                    capacity: int) -> torch.Tensor:
    """Validity-only (non-causal) mask: left_pad[b] <= j < total[b].
    Returns bool [B, capacity]."""
    dev = left_pad.device
    j = torch.arange(capacity, dtype=torch.int64, device=dev)[None, :]
    return (j >= left_pad.to(torch.int64)[:, None]) & (j < _cursor(total, dev))
