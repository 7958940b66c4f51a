"""Fused attention for chunked prefill over a fixed-capacity cache.

Port of mlx_vlm_tpu/ops/flash_attention.py (`flash_attention` :89, Pallas
kernel `_fa2_kernel` :31).  The CUDA kernel written for Hopper,
csrc/flash_attention.cu (K4), takes its place.

Query row i of batch row b sits at position offset[b] + i and keeps cache
column j when left_pad[b] <= j <= offset[b] + i (and j > position - window
with a window).  Scores are f32, masked scores are -0.7 * f32 max, the
softmax is online, and a row whose softmax sum is 0 divides by 1.

Bound on the H100, at the main path's shape (B = 1, H = 28, KVH = 4,
S = 512 against C = 8192 at offset 7680): operations, 58 GFLOP of visible
work, 0.059 ms at 989 TFLOP/s; beside them 115 M exponentials (about
0.03 ms at 16 per clock per SM) and 0.45 GB of K/V reads from L2.  The
kernel runs both products on `wgmma`, hides each tile's softmax (ex2,
masked only on tiles that cut a row's visible range) under the tensor
cores (the next tile's Q K^T and the last tile's P V are issued first, and
two warpgroups take turns), feeds K/V by TMA through a three-stage ring,
and reads each KV head's live tiles once per 128 query rows; the score
matrix never reaches device memory, and dead tiles are skipped.
`flash_attention_plan` gives its grid and tiles; the .cu header has the
design.

A row that sees no cache column is padding: the reference kernel averages
whatever tiles it visited there, so such rows are not part of the contract.

On CPU tensors `flash_attention` computes the plain PyTorch version
`flash_attention_plain`; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

NEG = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 128  # the kernel's head size
Q_TILE, KV_TILE = 128, 128  # query rows per block, cache columns per tile

launches = {"flash_attention": 0}


def flash_attention_plan(B: int, H: int, KVH: int, S: int, C: int,
                         D: int) -> tuple:
    """K4's (grid, query rows per block, cache columns per tile, KV splits)
    for q [B, H, S, D] against a cache [B, KVH, C, D].  One block takes 128
    query rows of one head (two consumer warpgroups of 64) and walks its KV
    head's live 128-column tiles itself: KV is never split, so no combine
    pass runs.  Raises for what the kernel does not take."""
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention: the CUDA kernel takes head_dim "
                         f"{HEAD_DIM}, not {D}")
    if min(B, H, KVH, S, C) < 1 or H % KVH or C % 64:
        raise ValueError(f"flash_attention: need B, S >= 1, H % KVH == 0 and "
                         f"C % 64 == 0 (B={B} H={H} KVH={KVH} S={S} C={C})")
    return (-(-S // Q_TILE), H, B), Q_TILE, KV_TILE, 1


def flash_attention_plain(q, k, v, offset, left_pad, scale: float,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain version of K4 in f32: materializes the [B, H, S, C] scores."""
    B, H, S, D = q.shape
    KVH, C = k.shape[1], k.shape[2]
    groups = H // KVH
    qg = q.float().reshape(B, KVH, groups, S, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    pos = offset.to(torch.int64)[:, None] + torch.arange(S, device=q.device)
    col = torch.arange(C, device=q.device)
    keep = (col[None, None, :] <= pos[:, :, None]) & (
        col[None, None, :] >= left_pad.to(torch.int64)[:, None, None])
    if window is not None:
        keep &= col[None, None, :] > pos[:, :, None] - window
    s = torch.where(keep[:, None, None], s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / l
    return out.reshape(B, H, S, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    offset: torch.Tensor, left_pad: torch.Tensor,
                    scale: float, window: Optional[int] = None) -> torch.Tensor:
    """q [B, H, S, D]; k/v [B, KVH, C, D]; offset/left_pad [B] int.

    Returns [B, H, S, D] in q.dtype."""
    if window is not None and window <= 0:
        raise ValueError("flash_attention: window must be positive or None")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, offset, left_pad, scale, window)
    B, H, S, D = q.shape
    KVH, C = k.shape[1], k.shape[2]
    if k.shape != (B, KVH, C, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: unsupported shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)}")
    flash_attention_plan(B, H, KVH, S, C, D)
    if q.device.type != "cuda":
        raise TypeError("flash_attention: the kernel runs on CUDA tensors")
    for a in (q, k, v):
        if a.dtype != torch.bfloat16 or a.device != q.device:
            raise TypeError("flash_attention: q/k/v must be bfloat16 on one device")
        if not a.is_contiguous():
            raise ValueError("flash_attention: q/k/v must be contiguous")
    if any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("flash_attention: q/k/v must be 16-byte aligned (the "
                         "kernel reads them by TMA)")
    off = offset.to(device=q.device, dtype=torch.int32).contiguous()
    lp = left_pad.to(device=q.device, dtype=torch.int32).contiguous()
    if off.shape != (B,) or lp.shape != (B,):
        raise ValueError("flash_attention: offset/left_pad must be [B]")
    o = torch.empty_like(q)
    lib = _cuda.library()
    err = lib.mvt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        off.data_ptr(), lp.data_ptr(), B, H, KVH, S, C, float(scale),
        int(window) if window is not None else 0,
        _cuda.stream_handle(q.device))
    _cuda.check(err, "flash_attention")
    _cuda.count(launches, "flash_attention")
    return o
