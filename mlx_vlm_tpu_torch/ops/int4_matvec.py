"""Grouped-int4 linears: y = x @ dequant(W).T for the halves-packed layout.

Port of mlx_vlm_tpu/ops/int4_matvec.py (`int4_matvec` :269 and its two Pallas
kernels).  Two CUDA kernels written for Hopper take their place:

K1, `int4_matmul` (csrc/int4_matmul.cu), replaces `_int4_matmul` (:159,
kernel `_mm_kern` :117) for more than MAX_KERNEL_ROWS rows: every prefill
linear.  Each weight dequantizes as code * s + b in f32 and rounds to x's
dtype before the product; products accumulate in f32 and the output is in
x's dtype.  Bound on the H100 by tensor-core work at prefill sizes; the
kernel dequantizes the weight straight into the A registers of `wgmma`,
fed by a TMA ring for x, and splits K when its tiles would leave SMs idle
(`int4_matmul_plan`; see the .cu header).  It takes any group size with
g % 16 == 0.

K2, `int4_matvec_rows` (csrc/int4_matvec.cu), replaces `_int4_matvec`
(:223, kernel `_kern` :61) for up to MAX_KERNEL_ROWS rows: the decode
linears and the prefill lm_head.  Each weight dequantizes as code * s + b in
f32, products and sums are f32, and the output is rounded once to x's dtype
(bf16 on the card).  Bound on the H100 by device-memory bandwidth; the
kernel is one launch per call that reads the weight once for all rows: a
TMA ring streams 128-column strips of the codes and their scales, each
group is factored as s * sum x (128 + q) + (b - 128 s) * sum x with the
sums on `mma.sync`, and K splits into slices (`int4_matvec_plan`), one
block each in a cluster per strip, whose partials the cluster adds in slice
order from distributed shared memory (see the .cu header).

The reference pads decode rows to 8 and indexes stacked weights with a
scalar-prefetched layer number; both are TPU artifacts.  Here a stacked
weight is sliced into per-layer views, which copy nothing.

On CPU tensors every wrapper computes its kernel's plain PyTorch version
(`int4_matmul_plain`, `int4_matvec_plain`); on CUDA tensors it launches the
kernel or raises.  `launches` counts kernel launches that execute, per
kernel: one per call, K1's split-K second pass included (one captured in a
CUDA graph counts at each replay: ops/_cuda.py `count`).
"""

from __future__ import annotations

import torch

from ..core.quant import Int4GroupedTensor, int4_grouped_dequantize
from . import _cuda

MAX_KERNEL_ROWS = 8
SMS = 132  # streaming multiprocessors of an H100 SXM
K2_SLICE_ROWS = 14 * 64  # K rows a K2 block streams at most (14 stages)
K2_MAX_SLICES = 16  # a K2 strip's cluster holds one block per K slice

launches = {"int4_matmul": 0, "int4_matvec": 0}


def int4_matmul_plain(x: torch.Tensor, t: Int4GroupedTensor) -> torch.Tensor:
    """Plain version of K1: x [M, K] -> [M, n] in x.dtype."""
    w = int4_grouped_dequantize(t, x.dtype).T
    return (x.float() @ w.float()).to(x.dtype)


def int4_matvec_plain(x: torch.Tensor, t: Int4GroupedTensor) -> torch.Tensor:
    """Plain version of K2: x [M, K] -> [M, n] in float32."""
    return x.float() @ int4_grouped_dequantize(t, torch.float32).T


def _check_weight(x: torch.Tensor, t: Int4GroupedTensor, name: str):
    K, n2p = t.qp.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match K={K}")
    for a in (t.qp, t.sl, t.sh, t.bl, t.bh):
        if a.device != x.device:
            raise ValueError(f"{name}: weight and x on different devices")
        if not a.is_contiguous():
            raise ValueError(f"{name}: weight arrays must be contiguous")
    if t.qp.dtype != torch.uint8:
        raise TypeError(f"{name}: qp must be uint8")
    for a in (t.sl, t.sh, t.bl, t.bh):
        if a.dtype != torch.float32 or a.shape != (K // t.group_size, 1, n2p):
            raise ValueError(f"{name}: scale planes must be f32 [G, 1, N2p]")
    if n2p % 128 or K % t.group_size or t.n > 2 * n2p:
        raise ValueError(f"{name}: unsupported shape K={K} N2p={n2p} n={t.n}")


def int4_matmul_plan(M: int, K: int, n2p: int, group_size: int) -> tuple:
    """K1's (row tile, split-K count) for x [M, K] and a weight of n2p
    packed columns.  A block computes a row tile of x against 64 packed
    columns (128 outputs).  The row tile is the tallest of 256, 128 and 64
    rows that is less than twice M and still gives SMS / 8 tiles or more
    (a taller tile dequantizes each weight for more rows; too few tiles
    would need a deep split), else 64.  When the tiles would leave SMs
    idle, K splits into S slices, S the largest that keeps the blocks at
    SMS or fewer and every slice at one quantization group and one 64-deep
    stage or more.  Raises for a group size the kernel does not take."""
    if group_size <= 0 or group_size % 16 or K % group_size:
        raise ValueError(f"int4_matmul: the CUDA kernel takes group sizes "
                         f"with g % 16 == 0 and K % g == 0, not g="
                         f"{group_size} at K={K}")
    cols = n2p // 64
    bm = next((b for b in (256, 128) if b < 2 * M
               and -(-M // b) * cols >= SMS // 8), 64)
    tiles = -(-M // bm) * cols
    most = -(-K // 64) // -(-group_size // 64)
    return bm, max(1, min(SMS // tiles, most))


def int4_matmul(x: torch.Tensor, t: Int4GroupedTensor) -> torch.Tensor:
    """K1: x [M, K] @ dequant(t).T -> [M, n] in x.dtype (single weight)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, t)
    _check_weight(x, t, "int4_matmul")
    M, K = x.shape
    n2p = t.qp.shape[1]
    bm, splits = int4_matmul_plan(M, K, n2p, t.group_size)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise TypeError("int4_matmul: the CUDA kernel takes bfloat16 x on CUDA")
    x = x.contiguous()
    if any(a.data_ptr() % 16 for a in (x, t.qp, t.sl, t.sh, t.bl, t.bh)):
        raise ValueError("int4_matmul: x and the weight arrays must be "
                         "16-byte aligned (the kernel reads them by TMA)")
    y = torch.empty((M, t.n), dtype=x.dtype, device=x.device)
    part = None
    if splits > 1:
        part = torch.empty((splits, M, t.n), dtype=torch.float32,
                           device=x.device)
    lib = _cuda.library()
    err = lib.mvt_int4_matmul(
        x.data_ptr(), t.qp.data_ptr(), t.sl.data_ptr(), t.sh.data_ptr(),
        t.bl.data_ptr(), t.bh.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), M, K, n2p, t.n,
        t.group_size, bm, splits, _cuda.stream_handle(x.device))
    _cuda.check(err, "int4_matmul")
    _cuda.count(launches, "int4_matmul")
    return y


def int4_matvec_plan(M: int, K: int, n2p: int, group_size: int) -> int:
    """K2's count S of K slices for x [M <= 8, K] and a weight of n2p packed
    columns.  A block streams one strip of 128 packed columns (256 outputs)
    over one slice of whole quantization groups.  S is the least count that
    gives two blocks per SM or more and slices of at most K2_SLICE_ROWS
    rows (shorter slices spread a call over more blocks, so that the last
    wave of blocks is short), but at most K2_MAX_SLICES (the slices of a
    strip form one thread-block cluster) and the group count.  Raises for a
    row count or group size the kernel does not take."""
    if not 1 <= M <= MAX_KERNEL_ROWS:
        raise ValueError(f"int4_matvec: the CUDA kernel takes 1 to "
                         f"{MAX_KERNEL_ROWS} rows, not {M}")
    if group_size <= 0 or group_size % 16 or K % group_size:
        raise ValueError(f"int4_matvec: the CUDA kernel takes group sizes "
                         f"with g % 16 == 0 and K % g == 0, not g="
                         f"{group_size} at K={K}")
    slices = max(-(-2 * SMS // (n2p // 128)), -(-K // K2_SLICE_ROWS))
    return min(K // group_size, K2_MAX_SLICES, slices)


def int4_matvec_rows(x: torch.Tensor, t: Int4GroupedTensor) -> torch.Tensor:
    """K2: x [M <= 8, K] @ dequant(t).T -> [M, n] in x.dtype (single
    weight; bf16 on the card)."""
    if x.device.type == "cpu":
        return int4_matvec_plain(x, t).to(x.dtype)
    _check_weight(x, t, "int4_matvec")
    M, K = x.shape
    n2p = t.qp.shape[1]
    slices = int4_matvec_plan(M, K, n2p, t.group_size)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise TypeError("int4_matvec: the CUDA kernel takes bfloat16 x on CUDA")
    x = x.contiguous()
    if any(a.data_ptr() % 16 for a in (x, t.qp, t.sl, t.sh, t.bl, t.bh)):
        raise ValueError("int4_matvec: x and the weight arrays must be "
                         "16-byte aligned (the kernel reads them by TMA)")
    y = torch.empty((M, t.n), dtype=x.dtype, device=x.device)
    lib = _cuda.library()
    err = lib.mvt_int4_matvec(
        x.data_ptr(), t.qp.data_ptr(), t.sl.data_ptr(), t.sh.data_ptr(),
        t.bl.data_ptr(), t.bh.data_ptr(), y.data_ptr(), M, K, n2p, t.n,
        t.group_size, slices, _cuda.stream_handle(x.device))
    _cuda.check(err, "int4_matvec")
    _cuda.count(launches, "int4_matvec")
    return y


def int4_matvec(x: torch.Tensor, t: Int4GroupedTensor,
                layer=None) -> torch.Tensor:
    """x [..., K] @ dequant(t).T -> [..., N] in x.dtype.

    `t` is a single weight ([K, N2p] arrays) or a stacked one ([L, K, N2p])
    with `layer` selecting a per-layer view.  Up to MAX_KERNEL_ROWS rows go
    through K2, more through K1."""
    if t.qp.dim() == 3:
        t = t.layer(layer if layer is not None else 0)
    *lead, K = x.shape
    M = 1
    for d in lead:
        M *= d
    if M == 0:
        return x.new_zeros((*lead, t.n))
    xm = x.reshape(M, K)
    if M > MAX_KERNEL_ROWS:
        y = int4_matmul(xm, t)
    else:
        y = int4_matvec_rows(xm, t)
    return y.reshape(*lead, t.n)
