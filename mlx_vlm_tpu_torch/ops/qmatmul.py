"""mlx group-affine linears: y = x @ dequant(W).T for the mlx byte layout.

Port of mlx_vlm_tpu/ops/qmatmul.py (`quantized_matmul_pallas` :174,
`_qmm_2d` :118 with its Pallas kernels `_qmm4_kernel` :53 and `_qmm8_kernel`
:83).  K5, one CUDA source written for Hopper (csrc/qmatmul.cu), takes
their place for every linear of an "exact" model, by two entry points:

- up to 8 rows (decode steps, the lm_head row), both widths: a GEMV on
  `mma.sync` with the codes exact as bf16 operands, one launch per call;
  `qmatmul_gemv_plan` picks its row tiles per block and its chunks of K;
- more than 8 rows (prefill chunks), both widths: a `wgmma` kernel on K1's
  pipeline with the codes exact in registers (an 8-bit code as two exact
  parts, two products into one partial); `qmatmul_plan` picks its row tile
  and K split, and a split K takes a second, ordered pass.

Each folds a group's f32 partial as s P + (b - c s) sum x (c = 128 at 4
bits, 384 at 8) and rounds once to bf16 (see the .cu header).

A third entry, `quantized_matmul_experts`, is the GEMV indexed by expert
for a mixture-of-experts layer (core/moe.py): one launch computes y[p] =
x[rows[p]] @ dequant(W[experts[p]]).T for every (row, expert) pair of a
stacked weight [E, N, K * bits / 8], the pairs read from int32 device
tensors by the kernel, so that a decode step holding it can be captured
in a CUDA graph.  The reference runs K5 on each expert's 2-D slice in
turn (core/moe.py:111-119, a masked scan over all E experts); the function
of each pair is K5's on that slice.

W is a 2-D QuantizedTensor: q uint8 [N, K * bits / 8] (4-bit: byte j of a
row holds code 2j in its low nibble and 2j+1 in its high nibble; 8-bit: one
code per byte), scales and biases [N, K / group_size].  The function is the
reference kernels': the weight dequantized in f32 (code * s + b), the
product accumulated in f32 over the whole of K, one rounding to x's dtype.
The reference's even/odd split of x is a Mosaic artifact (it cannot
interleave lanes) and is not carried over.

On CPU tensors the wrapper computes the plain version (`qmatmul_plain`); on
CUDA tensors it launches the kernel or raises.  `launches` counts calls
that execute, per bit width (a split GEMM's second pass is part of its
call; one captured in a CUDA graph counts at each replay: ops/_cuda.py
`count`).
"""

from __future__ import annotations

import torch

from ..core.quant import QuantizedTensor, dequantize
from . import _cuda

GROUP_SIZES = (32, 64, 128)
MAX_GEMV_ROWS = 8  # more rows take a GEMM route
SMS = 132  # streaming multiprocessors of an H100 SXM
# The GEMV's dynamic shared memory per block at most, so that two blocks
# share an SM's 228 KB; for its row tiles per block, the blocks at least
# (below, from GEMV_BIG_ROWS rows of x on) and the code bytes of a block at
# most (twice that from GEMV_BIG_ROWS rows on)
GEMV_SMEM_BYTES = 108 * 1024
GEMV_MIN_BLOCKS = (SMS * 4 // 5, SMS // 2)
GEMV_BLOCK_CODES = 128 * 1024
GEMV_BIG_ROWS = 4
# csrc/qmatmul.cu's GEMV constants: a warp's ring of code stages (MV_RING
# stages of 16 rows x (MV_SS * 32 + 16) bytes) and the bytes of a row a
# step covers (MV_STEP)
GEMV_WARP_RING = 2 * 16 * (4 * 32 + 16)
GEMV_STEP = 32
GEMV_RING_STEPS = 2 * 4  # MV_RING stages of MV_SS steps

# csrc/qmatmul.cu's GEMM constants: codes of K per ring stage, W rows per
# block, and the ring's stages per (bits, row tile) (QmmLayout::STAGES)
GEMM_BK = 64
GEMM_BN = 128
GEMM_STAGES = {(4, 64): 12, (4, 128): 8, (8, 64): 11, (8, 128): 8}
SMEM_PER_BLOCK = 232448  # an H100 block's shared memory at most (227 KB)

launches = {"qmatmul_int4": 0, "qmatmul_int8": 0, "qmatmul_experts": 0}


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


def _gemm_smem(bits: int, bm: int) -> int:
    """Dynamic shared memory of a GEMM block, as csrc/qmatmul.cu's
    QmmLayout lays it out: per stage x (bm x 64 bf16), the codes (128 rows
    x 64 * bits / 8 bytes) and the group data (two slots of (s, b - c s)
    per W row and of sums of x per x row, in whole KB); plus 1 KB of
    alignment slack."""
    meta = -(-(2 * GEMM_BN * 8 + 2 * bm * 4) // 1024) * 1024
    stage = bm * GEMM_BK * 2 + GEMM_BN * GEMM_BK * bits // 8 + meta
    return GEMM_STAGES[(bits, bm)] * stage + 1024


def qmatmul_plan(M: int, K: int, N: int, group_size: int,
                 bits: int = 4) -> tuple:
    """The GEMM route's (row tile, split-K count) for x [M, K] and a weight
    of N rows of `bits`-bit codes.  A block computes a row tile of x
    against 128 weight rows.  The row tile is 128 if that is less than
    twice M and still gives SMS / 8 tiles or more, else 64 (a taller tile
    reads each weight tile for more rows).  When the tiles would leave SMs
    idle, K splits into S slices of whole units of max(group_size, 64)
    codes, S the largest that keeps the blocks at SMS or fewer (and at most
    the unit count; at 8 bits and g = 32 a K that is an odd multiple of 32
    ends in a half stage, counted as a unit).  At 8 bits with a row tile of
    64, tiles that pass one wave of SMS blocks but leave the last wave part
    empty split K in two
    where half-length blocks need fewer half waves than twice the full
    waves (a 58-row chunk's 148 gate/up tiles: three half waves, not two
    full ones); the partials of so few rows cost little to add.  Raises
    for what the kernel does not take."""
    if M <= MAX_GEMV_ROWS:
        raise ValueError(f"qmatmul_plan: {M} rows take the GEMV route")
    if bits not in (4, 8) or group_size not in GROUP_SIZES:
        raise ValueError(f"qmatmul_plan: bits {bits} / group_size "
                         f"{group_size} not taken (bits 4 or 8, group "
                         f"{GROUP_SIZES})")
    # whole groups (at 4 bits whole group pairs); the K split's unit is
    # max(g, 64) codes, a trailing half stage counted as one
    step = 2 * group_size if bits == 4 else group_size
    if K % step:
        raise ValueError(f"qmatmul_plan: K={K} not taken at bits {bits} / "
                         f"group_size {group_size} (K a whole number of "
                         f"{step}-code units)")
    cols = -(-N // GEMM_BN)
    bm = 128 if 128 < 2 * M and -(-M // 128) * cols >= SMS // 8 else 64
    tiles = -(-M // bm) * cols
    units = -(-K // max(group_size, GEMM_BK))
    if (bits == 8 and bm == 64 and tiles > SMS and units >= 2
            and -(-2 * tiles // SMS) < 2 * -(-tiles // SMS)):
        return bm, 2
    return bm, max(1, min(SMS // tiles, units))


def _gemm(x: torch.Tensor, t: QuantizedTensor, K: int, N: int):
    """K5's GEMM route for x [M > 8, K] bf16 on the card, both widths."""
    M = x.shape[0]
    bm, splits = qmatmul_plan(M, K, N, t.group_size, t.bits)
    if any(a.data_ptr() % 16 for a in (x, t.q)) or any(
            a.data_ptr() % 4 for a in (t.scales, t.biases)):
        raise ValueError("quantized_matmul: x and q must be 16-byte aligned "
                         "(the GEMM reads them by TMA), scales and biases "
                         "4-byte aligned")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device)
    err = _cuda.library().mvt_qmatmul_gemm(
        x.data_ptr(), t.q.data_ptr(), t.scales.data_ptr(),
        t.biases.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), M, K, N, t.bits,
        t.group_size, bm, splits, _cuda.stream_handle(x.device))
    _cuda.check(err, "qmatmul")
    return y


def _gemv_persistent(K: int, N: int, bits: int, group_size: int, rt: int,
                     chunks: int) -> bool:
    """Whether csrc/qmatmul.cu:launch_qmv makes the GEMV's grid persistent
    (2 blocks an SM, each walking row tiles): one chunk of K, more tiles
    than that, and every warp's part of K GEMV_RING_STEPS steps or more."""
    unit = max(group_size * bits // 8, GEMV_STEP)
    steps = K * bits // 8 // unit // (8 // rt) * (unit // GEMV_STEP)
    return (chunks == 1 and -(-N // (16 * rt)) > 2 * SMS
            and steps >= GEMV_RING_STEPS)


def _gemv_smem(M: int, K: int, N: int, bits: int, group_size: int, rt: int,
               chunks: int) -> int:
    """Dynamic shared memory of a GEMV block, as csrc/qmatmul.cu:qmv_smem
    lays it out: 8 warps' rings; the scales and biases of a tile's 16 rt
    rows, whole rows with one chunk (in two slots when the grid is
    persistent: a block fetches its next tile's while it computes one),
    else the 32-bit words that hold a chunk's groups (one more group where
    a chunk starts at an odd one); M rows of x for a chunk, 16 bytes apart
    mod 128; 8 f32 sums of x per group of a chunk."""
    unit = max(group_size * bits // 8, GEMV_STEP)
    cu = -(-(K * bits // 8 // unit) // chunks)  # units of a chunk
    kc = cu * unit * 8 // bits  # codes of a chunk
    sbw = K // group_size if chunks == 1 else (kc // group_size + 2) // 2 * 2
    slots = 2 if _gemv_persistent(K, N, bits, group_size, rt, chunks) else 1
    return (8 * GEMV_WARP_RING + slots * 2 * 16 * rt * sbw * 2
            + M * (-(-kc * 2 // 128) * 128 + 16) + kc // group_size * 32)


def qmatmul_gemv_plan(M: int, K: int, N: int, bits: int,
                      group_size: int) -> tuple:
    """The GEMV route's (row tiles per block, chunks of K) for x [M <= 8, K]
    and a weight of N rows.  A block of 8 warps owns RT row tiles of 16 W
    rows, and its 8 / RT warps per tile split K; fewer, longer blocks stage
    x and start their streams for more rows.  RT is the largest of 8, 4
    and 2 that still gives GEMV_MIN_BLOCKS blocks of at most
    GEMV_BLOCK_CODES code bytes (from GEMV_BIG_ROWS rows of x on, where x
    weighs more, fewer blocks and twice the bytes), else 1.  K is cut into
    units of whole
    groups and whole 32-byte steps of a row; the chunks, whose x a block
    stages in turn, are the least power of two that keeps a block's shared
    memory within GEMV_SMEM_BYTES.  Raises for what the kernel does not
    take: K must be a whole number of units (any number of groups at 8
    bits, an odd one too; at 4 bits and g = 32, group pairs)."""
    if not 1 <= M <= MAX_GEMV_ROWS:
        raise ValueError(f"qmatmul_gemv_plan: {M} rows do not take the GEMV "
                         f"route (1 to {MAX_GEMV_ROWS})")
    if bits not in (4, 8) or group_size not in GROUP_SIZES:
        raise ValueError(f"qmatmul_gemv_plan: bits {bits} / group_size "
                         f"{group_size} not taken (bits 4 or 8, group "
                         f"{GROUP_SIZES})")
    if K % (max(group_size * bits // 8, GEMV_STEP) * 8 // bits):
        raise ValueError(f"qmatmul_gemv_plan: K={K} not taken at bits {bits} "
                         f"/ group_size {group_size} (K a whole number of "
                         f"{max(group_size, 8 * GEMV_STEP // bits)}-code "
                         f"units)")
    big = M >= GEMV_BIG_ROWS
    blocks, cap = GEMV_MIN_BLOCKS[big], GEMV_BLOCK_CODES * (2 if big else 1)
    rt = next((r for r in (8, 4, 2) if -(-N // (16 * r)) >= blocks
               and 16 * r * K * bits // 8 <= cap), 1)
    units = K * bits // 8 // max(group_size * bits // 8, GEMV_STEP)
    chunks = 1
    while (2 * chunks <= units and _gemv_smem(
            M, K, N, bits, group_size, rt, chunks) > GEMV_SMEM_BYTES):
        chunks *= 2
    return rt, chunks


def _gemv(x: torch.Tensor, t: QuantizedTensor, K: int, N: int):
    """K5's GEMV route for x [M <= 8, K] bf16 on the card."""
    M = x.shape[0]
    rt, chunks = qmatmul_gemv_plan(M, K, N, t.bits, t.group_size)
    if any(a.data_ptr() % 4 for a in (t.scales, t.biases)):
        raise ValueError("quantized_matmul: scales and biases must be 4-byte "
                         "aligned (the GEMV copies them as 32-bit words)")
    if x.data_ptr() % 16:
        x = x.clone()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _cuda.library().mvt_qmatmul_gemv(
        x.data_ptr(), t.q.data_ptr(), t.scales.data_ptr(),
        t.biases.data_ptr(), y.data_ptr(), M, K, N, t.bits, t.group_size, rt,
        chunks, _cuda.stream_handle(x.device))
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
    if x.shape[0] <= MAX_GEMV_ROWS:
        y = _gemv(x, t, K, N)
    else:
        y = _gemm(x, t, K, N)
    _cuda.count(launches, f"qmatmul_int{t.bits}")
    return y.reshape(*lead, N)


def qmatmul_experts_plain(x: torch.Tensor, t: QuantizedTensor,
                          experts: torch.Tensor,
                          rows=None) -> torch.Tensor:
    """Plain version of K5's expert-indexed entry: y [P, N] in x.dtype with
    y[p] = x[rows[p]] @ dequant(t[experts[p]]).T (rows None: x row p), from
    each pair's f32 dequantized expert and an f32 product."""
    xr = x if rows is None else x[rows.long()]
    e = experts.long()
    w = dequantize(QuantizedTensor(
        q=t.q[e], scales=t.scales[e], biases=t.biases[e], bits=t.bits,
        group_size=t.group_size, out_dtype=t.out_dtype), torch.float32)
    return torch.bmm(w, xr.float().unsqueeze(-1)).squeeze(-1).to(x.dtype)


def experts_kernel_route(t) -> bool:
    """Whether a stacked expert weight t [E, N, K * bits / 8] runs K5's
    expert-indexed entry, decided by shape alone: a 3-D 4- or 8-bit
    QuantizedTensor whose group size K5 takes, K a whole number of the
    GEMV's units (`qmatmul_gemv_plan` takes it), and an even number of
    values an expert (N * K / g), so that each expert's scales start on a
    32-bit word."""
    if not (isinstance(t, QuantizedTensor) and t.ndim == 3
            and t.bits in (4, 8) and t.group_size in GROUP_SIZES):
        return False
    _, N, K = t.shape
    unit = max(t.group_size * t.bits // 8, GEMV_STEP) * 8 // t.bits
    return K % unit == 0 and N * (K // t.group_size) % 2 == 0


def _check_experts(x: torch.Tensor, t: QuantizedTensor,
                   experts: torch.Tensor, rows) -> None:
    """Raise on anything the expert-indexed kernel does not take; reads
    shapes, dtypes, devices and addresses only, never a value."""
    if x.device.type != "cuda":
        raise TypeError("quantized_matmul_experts: the kernel runs on CUDA "
                        "tensors")
    _check_experts_args(x, t, experts, rows)


def _check_experts_args(x: torch.Tensor, t: QuantizedTensor,
                        experts: torch.Tensor, rows) -> None:
    """_check_experts' tests of dtypes, shapes and layout, which hold on any
    device."""
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise TypeError("quantized_matmul_experts: the kernel takes a 2-D "
                        "bfloat16 x")
    if not experts_kernel_route(t):
        raise ValueError(f"quantized_matmul_experts: a stacked weight of "
                         f"shape {tuple(t.shape)}, bits {t.bits}, group "
                         f"{t.group_size} is not taken")
    E, N, K = t.shape
    if x.shape[1] != K:
        raise ValueError(f"quantized_matmul_experts: x {tuple(x.shape)} does "
                         f"not match K={K}")
    idx = [experts] if rows is None else [experts, rows]
    for a in idx:
        if (a.dtype != torch.int32 or a.dim() != 1 or a.device != x.device
                or not a.is_contiguous() or a.shape != experts.shape):
            raise ValueError("quantized_matmul_experts: experts and rows "
                             "must be contiguous int32 [P] tensors on x's "
                             "device")
    if rows is None and experts.shape[0] != x.shape[0]:
        raise ValueError("quantized_matmul_experts: without rows, x has one "
                         "row a pair")
    if not 1 <= experts.shape[0] <= 65535:
        raise ValueError(f"quantized_matmul_experts: {experts.shape[0]} pairs "
                         f"(1 to 65535)")
    for a in (t.q, t.scales, t.biases):
        if a.device != x.device or not a.is_contiguous():
            raise ValueError("quantized_matmul_experts: weight arrays must be "
                             "contiguous, on x's device")
    for a in (t.scales, t.biases):
        if a.dtype != torch.bfloat16 or a.shape != (E, N, K // t.group_size):
            raise ValueError("quantized_matmul_experts: scales and biases "
                             "must be bfloat16 [E, N, K / group_size]")
    if t.q.data_ptr() % 16 or any(a.data_ptr() % 4
                                  for a in (t.scales, t.biases)):
        raise ValueError("quantized_matmul_experts: q must be 16-byte "
                         "aligned, scales and biases 4-byte aligned")


def quantized_matmul_experts(x: torch.Tensor, t: QuantizedTensor,
                             experts: torch.Tensor,
                             rows=None) -> torch.Tensor:
    """K5's expert-indexed entry: y [P, N] in x.dtype, y[p] = x[rows[p]] @
    dequant(t[experts[p]]).T, for x [R, K], a stacked t [E, N, K * bits /
    8] and int32 [P] `experts` and `rows` (rows None: row p of x, R = P).
    One launch on the card, whatever the pairs hold: the kernel reads them,
    so nothing here reads a value on the host and the call can be captured
    in a CUDA graph.  Its plan is the GEMV's at one row of x
    (`qmatmul_gemv_plan(1, ...)`), times the pairs."""
    if x.device.type == "cpu":
        return qmatmul_experts_plain(x, t, experts, rows)
    _check_experts(x, t, experts, rows)
    E, N, K = t.shape
    rt, chunks = qmatmul_gemv_plan(1, K, N, t.bits, t.group_size)
    x = x if x.data_ptr() % 16 == 0 and x.is_contiguous() else x.clone(
        memory_format=torch.contiguous_format)
    P = experts.shape[0]
    y = torch.empty((P, N), dtype=x.dtype, device=x.device)
    err = _cuda.library().mvt_qmatmul_gemv_experts(
        x.data_ptr(), t.q.data_ptr(), t.scales.data_ptr(),
        t.biases.data_ptr(), y.data_ptr(), experts.data_ptr(),
        None if rows is None else rows.data_ptr(), P, E, K, N, t.bits,
        t.group_size, rt, chunks, _cuda.stream_handle(x.device))
    _cuda.check(err, "qmatmul_experts")
    _cuda.count(launches, "qmatmul_experts")
    return y
