"""Scaled-dot-product attention as plain tensor math.

Port of mlx_vlm_tpu/ops/attention.py (sdpa :23) for boolean masks:
GQA-aware grouping without repeating KV heads, f32 scores and softmax,
probabilities cast to the input dtype before the value product, as in the
reference's einsum formulation.  Logit soft-capping, attention sinks and
additive masks (other model families) are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sdpa"]

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, nh, S, D]; k/v [B, nkv, C, D]; mask bool (True = attend)
    broadcastable to [B, nh, S, C].  Returns [B, nh, S, D] in q.dtype."""
    B, nh, S, D = q.shape
    nkv = k.shape[1]
    groups = nh // nkv
    dtype = q.dtype

    qg = q.reshape(B, nkv, groups, S, D)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError("sdpa: the mask must be boolean")
        m = mask
        if m.dim() == 4:  # [B, 1 or nh, S, C] -> group layout
            m = m[:, :, None] if m.shape[1] == 1 else m.reshape(B, nkv, groups, S, -1)
        scores = scores.masked_fill(~m, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs.to(dtype).float(), v.float())
    return out.reshape(B, nh, S, v.shape[-1]).to(dtype)
