"""mlx group-affine linears: y = x @ dequant(W).T for the mlx byte layout.

Port of mlx_vlm_tpu/ops/qmatmul.py (`quantized_matmul_pallas` :174,
`_qmm_2d` :118 with its Pallas kernels `_qmm4_kernel` :53 and `_qmm8_kernel`
:83).  K5, one CUDA source written for Hopper (csrc/qmatmul.cu), takes
their place for every linear of an "exact" model: prefill chunks (more
than 8 rows, tensor-core tiles) and decode steps and the lm_head (up to 8
rows, a GEMV).  4-bit prefill chunks take
their own entry point, a `wgmma` kernel on K1's pipeline with the codes
exact in registers and each group folded in f32 (`qmatmul_plan` picks its
row tile and K split; see the .cu header).

W is a 2-D QuantizedTensor: q uint8 [N, K * bits / 8] (4-bit: byte j of a
row holds code 2j in its low nibble and 2j+1 in its high nibble; 8-bit: one
code per byte), scales and biases [N, K / group_size].  The function is the
reference kernels': the weight dequantized in f32 (code * s + b), the
product accumulated in f32 over the whole of K, one rounding to x's dtype.
The reference's even/odd split of x is a Mosaic artifact (it cannot
interleave lanes) and is not carried over.

On CPU tensors the wrapper computes the plain version (`qmatmul_plain`); on
CUDA tensors it launches the kernel or raises.  `launches` counts calls
per bit width (a split int4 GEMM's second pass is part of its call).
"""

from __future__ import annotations

import torch

from ..core.quant import QuantizedTensor, dequantize
from . import _cuda

GROUP_SIZES = (32, 64, 128)
MAX_GEMV_ROWS = 8  # more rows take a GEMM route
SMS = 132  # streaming multiprocessors of an H100 SXM

launches = {"qmatmul_int4": 0, "qmatmul_int8": 0}


def qmatmul_plain(x: torch.Tensor, t: QuantizedTensor) -> torch.Tensor:
    """Plain version of K5: x [M, K] -> [M, N] in x.dtype, from the f32
    dequantized weight and an f32 product."""
    w = dequantize(t, torch.float32)
    return (x.float() @ w.T).to(x.dtype)


def _check(x: torch.Tensor, t: QuantizedTensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.device.type != "cuda":
        raise TypeError("quantized_matmul: the kernel runs on CUDA tensors")
    _check_args(x, t)


def _check_args(x: torch.Tensor, t: QuantizedTensor) -> None:
    """_check's tests of dtypes, shapes and layout, which hold on any
    device."""
    if x.dtype != torch.bfloat16:
        raise TypeError("quantized_matmul: the kernel takes bfloat16 x")
    if t.bits not in (4, 8) or t.group_size not in GROUP_SIZES:
        raise ValueError(f"quantized_matmul: bits {t.bits} / group_size "
                         f"{t.group_size} not taken (bits 4 or 8, group "
                         f"{GROUP_SIZES})")
    q, s, b = t.q, t.scales, t.biases
    if q.dim() != 2 or q.dtype != torch.uint8:
        raise ValueError("quantized_matmul: q must be a 2-D uint8 tensor")
    N, row_bytes = q.shape
    K = row_bytes * 8 // t.bits
    if x.shape[-1] != K:
        raise ValueError(f"quantized_matmul: x {tuple(x.shape)} does not "
                         f"match K={K}")
    if K % (t.group_size * (2 if t.bits == 4 else 1)):
        raise ValueError(f"quantized_matmul: K={K} is not a whole number of "
                         f"{'group pairs' if t.bits == 4 else 'groups'}")
    for a in (s, b):
        if a.dtype != torch.bfloat16 or a.shape != (N, K // t.group_size):
            raise ValueError("quantized_matmul: scales and biases must be "
                             "bfloat16 [N, K / group_size]")
    for a in (q, s, b):
        if a.device != x.device:
            raise ValueError("quantized_matmul: weight and x on different "
                             "devices")
        if not a.is_contiguous():
            raise ValueError("quantized_matmul: weight arrays must be "
                             "contiguous")
    if q.data_ptr() % 16:
        raise ValueError("quantized_matmul: q must be 16-byte aligned")


def qmatmul_plan(M: int, K: int, N: int, group_size: int) -> tuple:
    """The int4 GEMM route's (row tile, split-K count) for x [M, K] and a
    weight of N rows.  A block computes a row tile of x against 128 weight
    rows.  The row tile is 128 if that is less than twice M and still gives
    SMS / 8 tiles or more, else 64 (a taller tile reads each weight tile for
    more rows).  When the tiles would leave SMs idle, K splits into S
    slices of whole units of max(group_size, 64) codes, S the largest that
    keeps the blocks at SMS or fewer (and at most the unit count).  Raises
    for what the kernel does not take."""
    if M <= MAX_GEMV_ROWS:
        raise ValueError(f"qmatmul_plan: {M} rows take the GEMV route")
    if group_size not in GROUP_SIZES or K % (2 * group_size):
        raise ValueError(f"qmatmul_plan: group_size {group_size} at K={K} "
                         f"not taken (group {GROUP_SIZES}, K a multiple of "
                         f"2 * group_size)")
    cols = -(-N // 128)
    bm = 128 if 128 < 2 * M and -(-M // 128) * cols >= SMS // 8 else 64
    tiles = -(-M // bm) * cols
    units = K // max(group_size, 64)
    return bm, max(1, min(SMS // tiles, units))


def _int4_gemm(x: torch.Tensor, t: QuantizedTensor, K: int, N: int):
    """K5's int4 GEMM route for x [M > 8, K] bf16 on the card."""
    M = x.shape[0]
    bm, splits = qmatmul_plan(M, K, N, t.group_size)
    if any(a.data_ptr() % 16 for a in (x, t.q)) or any(
            a.data_ptr() % 4 for a in (t.scales, t.biases)):
        raise ValueError("quantized_matmul: x and q must be 16-byte aligned "
                         "(the int4 GEMM reads them by TMA), scales and "
                         "biases 4-byte aligned")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device)
    err = _cuda.library().mvt_qmatmul_int4_gemm(
        x.data_ptr(), t.q.data_ptr(), t.scales.data_ptr(),
        t.biases.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), M, K, N, t.group_size, bm,
        splits, _cuda.stream_handle(x.device))
    _cuda.check(err, "qmatmul")
    return y


def quantized_matmul_kernel(x: torch.Tensor, t: QuantizedTensor) -> torch.Tensor:
    """K5: x [..., K] @ dequant(t [N, K]).T -> [..., N] in x.dtype."""
    if t.q.dim() != 2:
        raise ValueError("quantized_matmul expects a 2-D (unstacked) weight")
    *lead, K = x.shape
    N = t.q.shape[0]
    x = x.reshape(-1, K)
    if x.device.type == "cpu":
        return qmatmul_plain(x, t).reshape(*lead, N)
    _check(x, t)
    if x.shape[0] == 0:
        return x.new_zeros((*lead, N))
    x = x.contiguous()
    if t.bits == 4 and x.shape[0] > MAX_GEMV_ROWS:
        y = _int4_gemm(x, t, K, N)
    else:
        if x.data_ptr() % 16:
            x = x.clone()
        y = torch.empty((x.shape[0], N), dtype=x.dtype, device=x.device)
        err = _cuda.library().mvt_qmatmul(
            x.data_ptr(), t.q.data_ptr(), t.scales.data_ptr(),
            t.biases.data_ptr(), y.data_ptr(), x.shape[0], K, N, t.bits,
            t.group_size, _cuda.stream_handle(x.device))
        _cuda.check(err, "qmatmul")
    launches[f"qmatmul_int{t.bits}"] += 1
    return y.reshape(*lead, N)
