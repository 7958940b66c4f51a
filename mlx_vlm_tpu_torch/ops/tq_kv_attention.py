"""Decode attention over TurboQuant (rotated Lloyd-Max codebook) KV codes.

Port of mlx_vlm_tpu/ops/tq_kv_attention.py: `tq_kv_decode_attention`
(:115, Pallas kernel `_kernel` :67, decode helper `_decode_tile` :40) and
`tq_kv_decode_attention_split` (:228, kernel `_split_kernel` :168).  One
CUDA source written for Hopper, csrc/tq_kv_attention.cu, takes the place of
both: K7 (one segment) and K8 (two segments).

Codes arrive in core/turboquant.py's strided bit-plane layout: for a
segment of Dseg dims and b bits, w = Dseg / 8 bytes per plane, and dim
d = i * w + m is bit i of byte m in each of the b planes (8-bit codes are
raw bytes).  A code decodes to lut[code], rounded to bf16.  The query is
rotated once outside and rounded to bf16.  Per-token scales fold into the
scores and probabilities:

    K7: score_c = (q . k_c) * ks_c * scale;  out = sum_c bf16(p_c * vs_c) v_c
    K8: score_c = ((q_A . kA_c) * ksA_c + (q_B . kB_c) * ksB_c) * scale,
        out = [sum_c bf16(p_c * vsA_c) vA_c, sum_c bf16(p_c * vsB_c) vB_c]

Column c is visible when left_pad <= c < offset; the softmax contract is
ops/int4_kv_attention.py's.

Bound on the H100: device-memory bytes (the packed codes and two f32
scales per visible token and KV head).  One launch a call: the kernel cuts
each KV head's capacity into splits of `tq_kv_attention_plan`'s tokens,
one block each, which stages its codes and scales by bulk copies and
decodes each code once into `mma.sync` operands for every query row of its
head; each split's softmax runs against its own maximum, and the last
blocks of a head combine the live splits.  See the .cu header.

On CPU tensors the wrappers compute the plain PyTorch versions; on CUDA
tensors they launch the kernel or raise.  `launches` counts calls whose
kernel executes (one captured in a CUDA graph counts at each replay:
ops/_cuda.py `count`).  A cache passes its device cursor and its device
codebooks (core/turboquant.py `_codebook`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

from ..core.turboquant import unpack_codes
from . import _cuda
# (MAX_COMBINERS, MAX_NT, MAX_TOKENS, MAX_WARPS and SMEM_BYTES stand here
# as mirrors of this kernel's constants and the plan's choices)
from .int4_kv_attention import (H100_SMS, MAX_COMBINERS, MAX_NT,  # noqa: F401
                                MAX_TOKENS, MAX_WARPS, SMEM_BYTES, TILE,
                                SplitPlan, _align16, _cdiv, _rows, _sms,
                                _tickets, bf16_round, online_softmax_out,
                                split_plan, visible)

launches = {"tq_kv_attention": 0, "tq_kv_attention_split": 0}

# Mirrors of csrc/tq_kv_attention.cu's other constants
MAX_SEGS = 2
LUT_ENTRIES = 256
GROUP_TILES = 8
ARRAY_SLACK = 32


@dataclasses.dataclass(frozen=True)
class SegGeometry:
    """How one segment's codes are cut into the kernel's 16-slot tiles
    (csrc/tq_kv_attention.cu `seg_geo`): w bytes a plane; a group is nm
    bytes of each plane cut into nm / 2 tiles of 16 / nm bit positions
    (8-bit codes: 16 consecutive dims a tile, 8 tiles a group)."""
    w: int
    nm: int
    groups: int
    steps: int


def seg_geometry(d: int, bits: int) -> SegGeometry:
    w = d // 8
    if bits == 8:
        steps = _cdiv(d, TILE)
        return SegGeometry(w, 16, _cdiv(steps, GROUP_TILES), steps)
    nm, steps = 16, None
    for cand in (16, 8, 4):
        tiles = cand // 2 * _cdiv(w, cand)
        if steps is None or tiles < steps:
            nm, steps = cand, tiles
    return SegGeometry(w, nm, _cdiv(w, nm), steps)


def _code_width(d: int, bits: int) -> int:
    return d if bits == 8 else d // 8 * bits


def _smem_bytes(segs, T: int, D: int, nt: int, warps: int) -> int:
    """A block's dynamic shared memory: the kernel's `tq_layout`."""
    rows = 8 * nt
    steps = sum(seg_geometry(d, kb).steps for d, kb, _ in segs)
    n = len(segs) * 2 * (LUT_ENTRIES * 2
                         + _align16(LUT_ENTRIES * 4 + ARRAY_SLACK))
    n += _align16(rows * D * 4 + ARRAY_SLACK) + nt * steps * 32 * 8
    n += rows * T * 4 + len(segs) * rows * T * 2 + _align16(rows * 2 * 4)
    n += rows * D * 4 + warps * rows * D * 4
    for d, kb, vb in segs:
        for width in (_code_width(d, kb), 4, 4, _code_width(d, vb)):
            n += _align16(T * width + ARRAY_SLACK)
    return n


TqPlan = SplitPlan


def tq_kv_attention_plan(BH: int, G: int, C: int, segs,
                         sms: int = H100_SMS) -> TqPlan:
    """The kernel's grid and block (ops/int4_kv_attention.py:split_plan)
    for BH KV heads of G query rows over a capacity of C tokens on a card
    of `sms` SMs; `segs` lists each segment's (dims, key bits, value
    bits)."""
    if not segs or len(segs) > MAX_SEGS or G < 1 or C < 1:
        raise ValueError(f"tq_kv_attention_plan: {len(segs)} segments, "
                         f"G={G}, C={C}")
    D = sum(d for d, _, _ in segs)
    return split_plan(BH, G, C,
                      lambda T, nt, warps: _smem_bytes(segs, T, D, nt, warps),
                      sms)


@functools.cache
def _lut_tensor(lut: tuple, device) -> torch.Tensor:
    return torch.tensor(lut, dtype=torch.float32, device=device)


def _lut(lut, device) -> torch.Tensor:
    """A codebook as f32 on `device`: a tensor (a cache's device codebook,
    core/turboquant.py `_codebook`) as it is, a sequence once per device."""
    if isinstance(lut, torch.Tensor):
        return lut.to(device=device, dtype=torch.float32)
    return _lut_tensor(tuple(float(x) for x in lut), device)


def _decoded(codes: torch.Tensor, lut, bits: int) -> torch.Tensor:
    """Packed codes [BH, C, w] -> bf16-rounded lut values [BH, C, Dseg]."""
    return bf16_round(_lut(lut, codes.device)[unpack_codes(codes, bits)
                                              .long()])


def tq_kv_decode_attention_plain(q_rot, kq, ks, vq, vs, offset, scale,
                                 k_bits: int, v_bits: int, k_lut, v_lut,
                                 left_pad):
    """Plain version of K7 in f32 with the kernel's bf16 roundings."""
    q = bf16_round(q_rot.float())
    s = torch.einsum("bgd,bcd->bgc", q, _decoded(kq, k_lut, k_bits))
    scores = s * ks[:, None] * scale
    vd = _decoded(vq, v_lut, v_bits)
    return online_softmax_out(
        scores, visible(offset, left_pad, kq.shape[1]),
        lambda p: torch.einsum("bgc,bcd->bgd", bf16_round(p * vs[:, None]),
                               vd))


def tq_kv_decode_attention_split_plain(q_rot, kqa, ksa, kqb, ksb, vqa, vsa,
                                       vqb, vsb, offset, scale, lo_bits: int,
                                       hi_bits: int, lo_lut, hi_lut,
                                       left_pad):
    """Plain version of K8 in f32 with the kernel's bf16 roundings."""
    q = bf16_round(q_rot.float())
    ka = _decoded(kqa, lo_lut, lo_bits)
    kb = _decoded(kqb, hi_lut, hi_bits)
    DA = ka.shape[-1]
    sa = torch.einsum("bgd,bcd->bgc", q[..., :DA], ka)
    sb = torch.einsum("bgd,bcd->bgc", q[..., DA:], kb)
    scores = (sa * ksa[:, None] + sb * ksb[:, None]) * scale
    va = _decoded(vqa, lo_lut, lo_bits)
    vb = _decoded(vqb, hi_lut, hi_bits)

    def acc(p):
        return torch.cat([
            torch.einsum("bgc,bcd->bgd", bf16_round(p * vsa[:, None]), va),
            torch.einsum("bgc,bcd->bgd", bf16_round(p * vsb[:, None]), vb)],
            dim=-1)

    return online_softmax_out(scores, visible(offset, left_pad, kqa.shape[1]),
                              acc)


def _launch(name: str, q_rot, segs, off, lp, scale: float) -> torch.Tensor:
    """Check the inputs and launch the kernel over 1 or 2 segments; each
    segment is (kq, ks, vq, vs, k_lut, v_lut, dseg, k_bits, v_bits)."""
    if q_rot.device.type != "cuda":
        raise TypeError(f"{name}: the kernel runs on CUDA tensors")
    BH, g, D = q_rot.shape
    C = segs[0][0].shape[1]
    if q_rot.dtype != torch.float32 or not q_rot.is_contiguous():
        raise TypeError(f"{name}: q_rot must be contiguous float32")
    if sum(s[6] for s in segs) != D:
        raise ValueError(f"{name}: segments do not cover D={D}")
    ptrs, ints = [], []
    for kq, ks, vq, vs, k_lut, v_lut, dseg, k_bits, v_bits in segs:
        if dseg % 8 or not (1 <= k_bits <= 8 and 1 <= v_bits <= 8):
            raise ValueError(f"{name}: segment of {dseg} dims at "
                             f"{k_bits}/{v_bits} bits")
        for codes, bits in ((kq, k_bits), (vq, v_bits)):
            if (codes.dtype != torch.uint8
                    or codes.shape != (BH, C, dseg * bits // 8)):
                raise ValueError(f"{name}: codes {tuple(codes.shape)} "
                                 f"{codes.dtype}, expected u8 "
                                 f"{(BH, C, dseg * bits // 8)}")
        for a in (kq, vq, ks, vs):
            if a.device != q_rot.device or not a.is_contiguous():
                raise ValueError(f"{name}: inputs must be contiguous on one "
                                 f"device")
        for a in (ks, vs):
            if a.dtype != torch.float32 or a.shape != (BH, C):
                raise ValueError(f"{name}: scales must be f32 [BH, C]")
        ptrs += [kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                 _lut(k_lut, q_rot.device).data_ptr(),
                 _lut(v_lut, q_rot.device).data_ptr()]
        ints += [dseg, k_bits, v_bits]
    nseg = len(segs)
    ptrs += [0] * (12 - len(ptrs))
    ints += [0] * (6 - len(ints))
    dev = q_rot.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    plan = tq_kv_attention_plan(BH, g, C, [s[6:] for s in segs], _sms(index))
    f32 = dict(dtype=torch.float32, device=dev)
    part_ml = torch.empty((plan.splits, BH, g, 2), **f32)
    part_acc = torch.empty((plan.splits, BH, g, D), **f32)
    out = torch.empty((BH, g, D), **f32)
    tickets = _tickets(dev, 2 * BH * plan.row_groups)
    err = _cuda.library().mvt_tq_kv_attention(
        q_rot.data_ptr(), *ptrs, off.data_ptr(), lp.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), tickets.data_ptr(),
        out.data_ptr(), *ints, nseg, BH, g, C, plan.tokens, plan.warps,
        plan.combiners, plan.smem_bytes, float(scale),
        _cuda.stream_handle(dev))
    _cuda.check(err, name)
    return out


def tq_kv_decode_attention(q_rot: torch.Tensor, kq: torch.Tensor,
                           ks: torch.Tensor, vq: torch.Tensor,
                           vs: torch.Tensor,
                           offset: Union[int, torch.Tensor], scale: float,
                           k_bits: int, v_bits: int, k_lut, v_lut,
                           left_pad: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K7.  q_rot f32 [BH, g, D] rotated query rows; kq/vq u8
    [BH, C, D*bits/8] bit-plane codes; ks/vs f32 [BH, C]; offset int or
    [BH]; left_pad [BH] or None -> out f32 [BH, g, D] (rotated domain)."""
    BH, g, D = q_rot.shape
    off = _rows(offset, BH, q_rot.device)
    lp = _rows(0 if left_pad is None else left_pad, BH, q_rot.device)
    if q_rot.device.type == "cpu":
        return tq_kv_decode_attention_plain(q_rot, kq, ks, vq, vs, off, scale,
                                            k_bits, v_bits, k_lut, v_lut, lp)
    out = _launch("tq_kv_decode_attention", q_rot,
                  [(kq, ks, vq, vs, k_lut, v_lut, D, k_bits, v_bits)],
                  off, lp, scale)
    _cuda.count(launches, "tq_kv_attention")
    return out


def tq_kv_decode_attention_split(q_rot: torch.Tensor, kqa, ksa, kqb, ksb,
                                 vqa, vsa, vqb, vsb,
                                 offset: Union[int, torch.Tensor],
                                 scale: float, lo_bits: int, hi_bits: int,
                                 lo_lut, hi_lut,
                                 left_pad: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """K8.  Segment A: the first DA rotated dims at lo_bits (kqa/vqa
    [BH, C, DA*lo/8]); segment B: the last DB at hi_bits (kqb/vqb
    [BH, C, DB*hi/8]); per-token per-segment scales f32 [BH, C];
    q_rot f32 [BH, g, DA+DB] -> out f32 [BH, g, DA+DB]."""
    BH, g, D = q_rot.shape
    off = _rows(offset, BH, q_rot.device)
    lp = _rows(0 if left_pad is None else left_pad, BH, q_rot.device)
    if q_rot.device.type == "cpu":
        return tq_kv_decode_attention_split_plain(
            q_rot, kqa, ksa, kqb, ksb, vqa, vsa, vqb, vsb, off, scale,
            lo_bits, hi_bits, lo_lut, hi_lut, lp)
    DA = kqa.shape[-1] * 8 // lo_bits
    out = _launch("tq_kv_decode_attention_split", q_rot,
                  [(kqa, ksa, vqa, vsa, lo_lut, lo_lut, DA, lo_bits, lo_bits),
                   (kqb, ksb, vqb, vsb, hi_lut, hi_lut, D - DA, hi_bits,
                    hi_bits)], off, lp, scale)
    _cuda.count(launches, "tq_kv_attention_split")
    return out
