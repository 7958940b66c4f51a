"""Decode attention over a per-token-affine 4-bit KV cache.

Port of mlx_vlm_tpu/ops/int4_kv_attention.py (`int4_kv_decode_attention`
:104, Pallas kernel `_kernel` :35).  The CUDA kernel written for Hopper,
csrc/int4_kv_attention.cu (K6), takes its place.

Codes pack along the head dim in two half planes (dims [0, D/2) in the low
nibble, [D/2, D) in the high one).  The g query rows of one KV head arrive
pre-quantized to int8 with a row scale qs and their code sum; per-token
scales fold into the score and probability domain:

    score_c = qs * (ks_c * (q8 . k4_c) + kb_c * sum(q8)) * scale

Column c is visible when left_pad <= c < offset.  Softmax is in f32; the
value side rounds p * vs_c to bf16 against the codes and adds the bias as a
rank-1 term sum_c p_c * vb_c; a row that sees nothing divides by 1e-30
(and is 0).

Bound on the H100: device-memory bytes (D + 16 bytes per visible token and
KV head at 4 bits).  One launch a call: the kernel cuts each KV head's
capacity into splits of `int4_kv_attention_plan`'s tokens, one block each,
which stages its codes and scales by bulk copies, takes the integer key
dots on `mma.sync` with s8 operands and the values on bf16 `mma.sync`, for
every query row of its head; each split's softmax runs against its own
maximum, and the last blocks of a head combine the live splits.  See the
.cu header.

On CPU tensors the wrapper computes the plain PyTorch version
`int4_kv_decode_attention_plain`; on CUDA tensors it launches the kernel or
raises.  `launches` counts the kernel's launches that execute (one
captured in a CUDA graph counts at each replay: ops/_cuda.py `count`).  A
cache passes its device cursor (`_rows`), which the kernel reads when it
runs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

from . import _cuda

launches = {"int4_kv_attention": 0}

# Mirrors of csrc/int4_kv_attention.cu's constants
TILE = 16          # tokens of one mma tile; a split is whole tiles
MAX_NT = 2         # n-tiles of 8 query rows a block serves
MAX_WARPS = 12     # 8 at two n-tiles
ARRAY_SLACK = 48
MAX_COMBINERS = 8
KEY_BYTES = 16     # code bytes of a token per key k-step
GROUP_BYTES = 32   # code bytes of a token per group of 4 value m-tiles
# The plan's choices (shared with ops/tq_kv_attention.py): blocks per SM
# the grid aims at, the longest split, and the shared memory a block may
# take on the H100
BLOCKS_PER_SM = 1
MAX_TOKENS = 512
SMEM_BYTES = 232448
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def key_steps(D: int) -> int:
    """k-steps of the key dot: KEY_BYTES code bytes of a token each."""
    return _cdiv(D // 2, KEY_BYTES)


def _smem_bytes(T: int, D: int, nt: int, warps: int) -> int:
    """A block's dynamic shared memory: the kernel's `kv4_layout`."""
    rows, h = 8 * nt, D // 2
    n = _align16(rows * D + ARRAY_SLACK) + _align16(rows * 8 + ARRAY_SLACK)
    n += nt * key_steps(D) * 32 * 8
    n += rows * T * 4 + rows * T * 2 + _align16(rows * 8) + _align16(rows * 4)
    n += rows * D * 4 + warps * rows * D * 4
    for width in (h, 4, 4, 4, 4, h):
        n += _align16(T * width + ARRAY_SLACK)
    return n


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    tokens: int      # T: tokens of one split (one block), a multiple of 16
    splits: int      # NS = ceil(C / T) splits per KV head
    combiners: int   # the last blocks of a head to arrive, which combine
    warps: int       # warps per block
    n_tiles: int     # 8-row n-tiles of query rows a block serves
    row_groups: int  # blocks per split along the query rows
    smem_bytes: int


def split_plan(BH: int, G: int, C: int, smem_bytes, sms: int) -> SplitPlan:
    """The grid and block of a split decode-attention kernel (K6, K7, K8)
    for BH KV heads of G query rows over a capacity of C tokens on a card
    of `sms` SMs; `smem_bytes(T, nt, warps)` is a block's shared memory.
    The grid is sized from C (not the cursor) for about BLOCKS_PER_SM
    blocks per SM: each KV head's capacity is cut into NS splits of T
    tokens (whole 16-token tiles, at most MAX_TOKENS), one block each; on
    the card a row's NS splits cover its history [0, min(C, offset)) in
    whole tiles of at most T tokens.  A block takes the fewest warps (at
    most MAX_WARPS, 8 with two n-tiles) that leave no warp more tiles than
    that many warps would; T halves while a block's shared memory passes
    SMEM_BYTES.  G <= 8 rows take one n-tile, more take two, and past 16
    the rows are cut into groups of 16.  The last `combiners` blocks of a
    head to arrive combine its splits: at most MAX_COMBINERS and SMs /
    heads, so that the blocks waiting for the rest can never hold every
    SM."""
    nt = 1 if G <= 8 else MAX_NT
    Z = _cdiv(G, 8 * nt)
    per_head = max(1, BLOCKS_PER_SM * sms // (BH * Z))
    T = min(MAX_TOKENS, _cdiv(_cdiv(C, per_head), TILE) * TILE)
    most = MAX_WARPS if nt == 1 else 8
    while True:
        tiles = T // TILE
        warps = _cdiv(tiles, _cdiv(tiles, most))
        smem = smem_bytes(T, nt, warps)
        if smem <= SMEM_BYTES:
            NS = _cdiv(C, T)
            K = min(MAX_COMBINERS, NS, max(1, sms // (BH * Z)))
            return SplitPlan(T, NS, K, warps, nt, Z, smem)
        if T == TILE:
            raise ValueError(f"split_plan: {smem} bytes of shared memory at "
                             f"16 tokens a split")
        T = max(TILE, T // 2 // TILE * TILE)


def int4_kv_attention_plan(BH: int, G: int, C: int, D: int,
                           sms: int = H100_SMS) -> SplitPlan:
    """K6's grid and block (`split_plan`) for BH KV heads of G query rows
    over C tokens of head dim D; D must be a multiple of 8, so that every
    token's code row is whole 32-bit words."""
    if G < 1 or C < 1 or BH < 1 or D < 8 or D % 8:
        raise ValueError(f"int4_kv_attention_plan: BH={BH}, G={G}, C={C}, "
                         f"D={D}")
    return split_plan(BH, G, C,
                      lambda T, nt, warps: _smem_bytes(T, D, nt, warps), sms)


_TICKETS: dict = {}


def _tickets(dev, n: int) -> torch.Tensor:
    """The card's ticket counters, shared by K6, K7 and K8: zeroed once,
    and every launch leaves them as it found them."""
    t = _TICKETS.get(dev.index)
    if t is None or t.numel() < n:
        t = _TICKETS[dev.index] = torch.zeros(max(n, 4096),
                                              dtype=torch.int32, device=dev)
    return t


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def visible(offset: torch.Tensor, left_pad: torch.Tensor, C: int):
    """bool [BH, 1, C]: left_pad <= c < offset for each row."""
    col = torch.arange(C, device=offset.device)
    return ((col[None] < offset.to(torch.int64)[:, None])
            & (col[None] >= left_pad.to(torch.int64)[:, None]))[:, None]


def online_softmax_out(scores, keep, acc_fn):
    """The kernels' softmax contract: p = exp(s - max) over the visible
    columns, out = acc_fn(p) / max(sum p, 1e-30); rows that see nothing get
    p = 0 (and out = 0)."""
    s = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    return acc_fn(p) / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _rows(x, BH: int, device) -> torch.Tensor:
    """A cursor -> int32 [BH] on `device`: a cache's device cursor (0-dim,
    expanded to every row on the device, never read on the host), a [BH]
    tensor of per-row cursors, or an int."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device, dtype=torch.int32).reshape(-1)
        return t.expand(BH).contiguous() if t.numel() == 1 else t.contiguous()
    return torch.full((BH,), int(x), dtype=torch.int32, device=device)


def int4_kv_decode_attention_plain(q8, qsum_qs, k4, ks, kb, v4, vs, vb,
                                   offset, scale: float, left_pad):
    """Plain version of K6 in f32 (integer dots exact in f32)."""
    BH, C, h = k4.shape
    k = torch.cat([k4 & 0xF, k4 >> 4], dim=-1).float()  # [BH, C, D]
    v = torch.cat([v4 & 0xF, v4 >> 4], dim=-1).float()
    qsum, qs = qsum_qs[..., :1].float(), qsum_qs[..., 1:2].float()
    s_i = torch.einsum("bgd,bcd->bgc", q8.float(), k)
    scores = (s_i * ks[:, None] + qsum * kb[:, None]) * qs * scale
    keep = visible(offset, left_pad, C)

    def acc(p):
        pv = bf16_round(p * vs[:, None])
        return (torch.einsum("bgc,bcd->bgd", pv, v)
                + (p * vb[:, None]).sum(dim=-1, keepdim=True))

    return online_softmax_out(scores, keep, acc)


def int4_kv_decode_attention(q8: torch.Tensor, qsum_qs: torch.Tensor,
                             k4: torch.Tensor, ks: torch.Tensor,
                             kb: torch.Tensor, v4: torch.Tensor,
                             vs: torch.Tensor, vb: torch.Tensor,
                             offset: Union[int, torch.Tensor], scale: float,
                             left_pad: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """q8 int8 [BH, g, D]; qsum_qs f32 [BH, g, 2] (sum(q8), qs); k4/v4 u8
    [BH, C, D/2]; ks/kb/vs/vb f32 [BH, C]; offset int or int [BH] (columns
    < offset are visible); left_pad [BH] or None -> out f32 [BH, g, D]."""
    BH, g, D = q8.shape
    C = k4.shape[1]
    off = _rows(offset, BH, q8.device)
    lp = _rows(0 if left_pad is None else left_pad, BH, q8.device)
    if q8.device.type == "cpu":
        return int4_kv_decode_attention_plain(q8, qsum_qs, k4, ks, kb, v4,
                                              vs, vb, off, scale, lp)
    if q8.device.type != "cuda":
        raise TypeError("int4_kv_decode_attention: the kernel runs on CUDA "
                        "tensors")
    if D % 8 or k4.shape != (BH, C, D // 2) or v4.shape != k4.shape:
        raise ValueError(f"int4_kv_decode_attention: unsupported shapes "
                         f"q8 {tuple(q8.shape)} k4 {tuple(k4.shape)} (D a "
                         f"multiple of 8)")
    for a, dt, shape in ((q8, torch.int8, None), (qsum_qs, torch.float32,
                                                  (BH, g, 2)),
                         (k4, torch.uint8, None), (v4, torch.uint8, None),
                         (ks, torch.float32, (BH, C)),
                         (kb, torch.float32, (BH, C)),
                         (vs, torch.float32, (BH, C)),
                         (vb, torch.float32, (BH, C))):
        if a.dtype != dt or a.device != q8.device or not a.is_contiguous():
            raise TypeError("int4_kv_decode_attention: inputs must be "
                            "contiguous, on one device, of the documented "
                            "dtypes")
        if shape is not None and a.shape != shape:
            raise ValueError(f"int4_kv_decode_attention: shape "
                             f"{tuple(a.shape)}, expected {shape}")
    if q8.data_ptr() % 4 or k4.data_ptr() % 4 or v4.data_ptr() % 4:
        raise ValueError("int4_kv_decode_attention: q8, k4 and v4 must be "
                         "4-byte aligned")
    dev = q8.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    plan = int4_kv_attention_plan(BH, g, C, D, _sms(index))
    f32 = dict(dtype=torch.float32, device=dev)
    part_ml = torch.empty((plan.splits, BH, g, 2), **f32)  # max, sum of p
    part_acc = torch.empty((plan.splits, BH, g, D), **f32)
    out = torch.empty((BH, g, D), **f32)
    tickets = _tickets(dev, 2 * BH * plan.row_groups)
    err = _cuda.library().mvt_int4_kv_attention(
        q8.data_ptr(), qsum_qs.data_ptr(), k4.data_ptr(), ks.data_ptr(),
        kb.data_ptr(), v4.data_ptr(), vs.data_ptr(), vb.data_ptr(),
        off.data_ptr(), lp.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), tickets.data_ptr(), out.data_ptr(), BH, g, C, D,
        plan.tokens, plan.warps, plan.combiners, plan.smem_bytes,
        float(scale), _cuda.stream_handle(dev))
    _cuda.check(err, "int4_kv_decode_attention")
    _cuda.count(launches, "int4_kv_attention")
    return out
