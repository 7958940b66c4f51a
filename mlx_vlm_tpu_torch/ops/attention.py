"""Scaled-dot-product attention as plain tensor math.

Port of mlx_vlm_tpu/ops/attention.py (sdpa :23) for boolean masks:
GQA-aware grouping without repeating KV heads, f32 scores and softmax,
probabilities cast to the input dtype before the value product, as in the
reference's einsum formulation, logit soft-capping (gemma2's
tanh(scores / cap) * cap on the f32 scores before the mask, :47-48) and
attention sinks (gpt-oss's one learned f32 logit per head, :63-70: one
extra score column after the cap and the mask, in the softmax's
denominator, its probability then dropped).  Additive masks (other model
families) are not ported.

`segment_sdpa` is the vision towers' attention within segments (an
image's frame, a video's frame group, a window): each run of equal-length
segments in batches of segments, so that no [N, N] mask or score tensor is
made, where the reference attends all N patches at once under a
block-diagonal mask.  Masked entries add exactly 0 there, so the two
differ by the order of the sums alone.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sdpa", "softmax_with_sinks", "segment_runs", "segment_sdpa"]

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def softmax_with_sinks(scores: torch.Tensor,
                       sinks: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax of f32 scores [B, nkv, g, S, C] over the last axis; with
    `sinks` ([nh] = [nkv * g], one logit per head) each head's sink joins
    its row as one more column and its probability is dropped, so a row
    whose keys are all masked gives its mass to the sink."""
    if sinks is None:
        return torch.softmax(scores, dim=-1)
    B, nkv, g, S, _ = scores.shape
    col = sinks.float().reshape(1, nkv, g, 1, 1).expand(B, nkv, g, S, 1)
    return torch.softmax(torch.cat([scores, col], dim=-1), dim=-1)[..., :-1]


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         mask: Optional[torch.Tensor] = None,
         logit_softcap: Optional[float] = None,
         sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, nh, S, D]; k/v [B, nkv, C, D]; mask bool (True = attend)
    broadcastable to [B, nh, S, C]; `logit_softcap` caps the scaled
    scores; `sinks` [nh] f32 sink logits (`softmax_with_sinks`).  Returns
    [B, nh, S, D] in q.dtype."""
    B, nh, S, D = q.shape
    nkv = k.shape[1]
    groups = nh // nkv
    dtype = q.dtype

    qg = q.reshape(B, nkv, groups, S, D)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.float(), k.float()) * scale
    if logit_softcap is not None:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError("sdpa: the mask must be boolean")
        m = mask
        if m.dim() == 4:  # [B, 1 or nh, S, C] -> group layout
            m = m[:, :, None] if m.shape[1] == 1 else m.reshape(B, nkv, groups, S, -1)
        scores = scores.masked_fill(~m, _NEG_INF)
    probs = softmax_with_sinks(scores, sinks)
    out = torch.einsum("bkgst,bktd->bkgsd", probs.to(dtype).float(), v.float())
    return out.reshape(B, nh, S, v.shape[-1]).to(dtype)


# f32 score bytes that one batch of segments may take in segment_sdpa
SEGMENT_SCORE_BYTES = 1 << 30


def segment_runs(segment_ids: torch.Tensor) -> list:
    """[(start, length, count)]: the runs of consecutive segments of one
    length in [N] segment ids, each segment a contiguous block of one id.
    Reads the ids on the host (one wait for the card there)."""
    _, counts = torch.unique_consecutive(segment_ids, return_counts=True)
    runs: list = []
    start = 0
    for n in counts.tolist():
        if runs and runs[-1][1] == n:
            runs[-1][2] += 1
        else:
            runs.append([start, n, 1])
        start += n
    return [tuple(r) for r in runs]


def segment_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, runs: list) -> torch.Tensor:
    """Attention of each segment to itself: q / k / v [1, heads, N, D] with
    the segments `runs` (segment_runs) -> [1, heads, N, D] in q.dtype.
    Each run's segments go through `sdpa` as a batch, at most as many at a
    time as keep the f32 scores under SEGMENT_SCORE_BYTES."""
    H, D = q.shape[1], q.shape[3]
    out = torch.empty_like(q)
    for start, n, count in runs:
        per = max(1, SEGMENT_SCORE_BYTES // (H * n * n * 4))
        for s0 in range(0, count, per):
            m = min(per, count - s0)
            rows = slice(start + s0 * n, start + (s0 + m) * n)

            def batch(x):  # [1, H, m * n, D] -> [m, H, n, D]
                return x[0, :, rows].reshape(H, m, n, D).transpose(0, 1)

            o = sdpa(batch(q), batch(k), batch(v), scale)
            out[0, :, rows] = o.transpose(0, 1).reshape(H, m * n, D)
    return out
