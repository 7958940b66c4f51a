"""TurboQuant-style rotated codebook KV quantization.

Port of mlx_vlm_tpu/core/turboquant.py (Lloyd-Max levels :31-87,
pack_codes :92, unpack_codes :122, hadamard_transform :143, _signs :164,
tq_encode :169, tq_decode :188, TurboQuantKVCache :211, tq_encode_split
:363, SplitTurboQuantKVCache :411, make_rotated_int4_cache :598, its
`per_row` :599-608).

Keys and values are rotated (random sign flips, then the normalized
Walsh-Hadamard transform), scaled per token to unit RMS and encoded against
Lloyd-Max levels of a unit Gaussian.  Codes are stored in the reference's
strided bit-plane layout: plane j holds bit j of every code, and byte m of
a plane carries at bit i the bit of dim i * (D / 8) + m.  The layout is the
cache's storage format and stays bit-exact with the reference.

Decode attention (S == 1) runs on the packed codes through
ops/tq_kv_attention.py (K7 for `TurboQuantKVCache`, K8 for the split
cache) with the query rotated once outside; `MLX_VLM_TPU_TQ_FUSED=0` takes
the dequantize + `sdpa` route instead, as in the reference, and so does
a soft-capped attend or one with attention sinks (the kernels take
neither; the reference's rules :278, :482).  The caches
write in place by index at their device cursor `offset`, like `KVCache`,
and hand the kernels the cursor and the device codebooks (`_codebook`), so
that a decode step reads nothing on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional

import numpy as np
import torch

from . import cache as cache_lib

# Lloyd-Max (MSE-optimal) quantizer levels for a unit Gaussian.
_LLOYD_MAX = {
    1: [-0.7979, 0.7979],
    2: [-1.5104, -0.4528, 0.4528, 1.5104],
    3: [-2.1519, -1.3439, -0.7560, -0.2451, 0.2451, 0.7560, 1.3439, 2.1519],
    4: [-2.7326, -2.0690, -1.6181, -1.2562, -0.9423, -0.6568, -0.3880,
        -0.1284, 0.1284, 0.3880, 0.6568, 0.9423, 1.2562, 1.6181, 2.0690,
        2.7326],
}


def _lloyd_max_levels(n: int, iters: int = 500) -> np.ndarray:
    """Numerically derive MSE-optimal unit-Gaussian levels (Lloyd's
    algorithm with closed-form truncated-Gaussian centroids)."""
    from math import erf, pi, sqrt

    phi = lambda t: np.exp(-0.5 * t * t) / sqrt(2 * pi)  # noqa: E731
    Phi = np.vectorize(lambda t: 0.5 * (1 + erf(t / sqrt(2))))
    qs = (np.arange(n) + 0.5) / n
    levels = np.array([_norm_ppf(q) for q in qs])
    for _ in range(iters):
        b = (levels[1:] + levels[:-1]) / 2.0
        lo = np.concatenate([[-12.0], b])
        hi = np.concatenate([b, [12.0]])
        mass = Phi(hi) - Phi(lo)
        levels = (phi(lo) - phi(hi)) / np.maximum(mass, 1e-300)
    return levels


def _norm_ppf(q: float) -> float:
    from math import erf, sqrt

    lo, hi = -12.0, 12.0
    for _ in range(80):
        mid = (lo + hi) / 2
        if 0.5 * (1 + erf(mid / sqrt(2))) < q:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def _levels(bits: int) -> np.ndarray:
    if bits not in _LLOYD_MAX:
        if not 1 <= bits <= 8:
            raise ValueError(f"unsupported bits {bits}")
        _LLOYD_MAX[bits] = _lloyd_max_levels(1 << bits).tolist()
    return np.asarray(_LLOYD_MAX[bits])


# The small constant tables are made once per device: a fresh host-to-device
# copy in every layer's attend would stall the host on each decode step.


@functools.cache
def _codebook(bits: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_levels(bits).astype(np.float32)).to(device)


@functools.cache
def _boundaries(bits: int, device=None) -> torch.Tensor:
    cb = _levels(bits)
    return torch.from_numpy(((cb[1:] + cb[:-1]) / 2.0).astype(np.float32)).to(
        device)


# --------------------------------------------------------------- bit packing


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """[..., D] b-bit codes -> [..., D*bits/8] u8 in the strided bit-plane
    layout (8-bit codes are stored as they are)."""
    if bits == 8:
        return codes.to(torch.uint8)
    D = codes.shape[-1]
    if D % 8:
        raise ValueError(f"last dim {D} must be a multiple of 8")
    w = D // 8
    c = codes.to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=codes.device))[:, None]
    planes = []
    for j in range(bits):
        grouped = ((c >> j) & 1).reshape(*codes.shape[:-1], 8, w)  # [.., i, m]
        planes.append((grouped * weights).sum(-2).to(torch.uint8))
    return torch.cat(planes, dim=-1)


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of pack_codes: [..., D*bits/8] bytes -> [..., D] u8 codes."""
    if bits == 8:
        return packed
    D = packed.shape[-1] * 8 // bits
    lead = packed.shape[:-1]
    planes = packed.reshape(*lead, bits, D // 8).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bit = (planes[..., None] >> shifts) & 1  # [.., bits, m, i]
    bit = bit.transpose(-1, -2).reshape(*lead, bits, D)  # dims i*w + m
    weights = (1 << torch.arange(bits, dtype=torch.int32,
                                 device=packed.device))[:, None]
    return (bit * weights).sum(-2).to(torch.uint8)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def hadamard_transform(x: torch.Tensor) -> torch.Tensor:
    """Normalized Walsh-Hadamard transform over the last (power-of-2) axis,
    in float32, with the reference's butterfly order.  Self-inverse."""
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"dim {d} must be a power of 2")
    orig = x.shape
    x = x.to(torch.float32).reshape(-1, d)
    h = 1
    while h < d:
        x = x.reshape(-1, d // (2 * h), 2, h)
        a, b = x[:, :, 0], x[:, :, 1]
        x = torch.stack([a + b, a - b], dim=2)
        h *= 2
    return x.reshape(orig) / math.sqrt(d)


@functools.cache
def _signs(d: int, device=None, seed: int = 1234) -> torch.Tensor:
    """The rotation's random signs, drawn with numpy as in the reference."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice([-1.0, 1.0], size=d).astype(
        np.float32)).to(device)


def _rotate_padded(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """f32 hadamard(pad(x) * signs), the head dim zero-padded to pow-2."""
    d, p2 = x.shape[-1], signs.shape[0]
    xf = x.to(torch.float32)
    if p2 != d:
        xf = torch.nn.functional.pad(xf, (0, p2 - d))
    return hadamard_transform(xf * signs)


def _encode(seg: torch.Tensor, bits: int):
    """Per-token RMS scale + codebook search of rotated values."""
    sc = torch.sqrt(seg.square().mean(dim=-1, keepdim=True) + 1e-8)
    codes = torch.searchsorted(_boundaries(bits, seg.device),
                               (seg / sc).contiguous())
    return pack_codes(codes, bits), sc[..., 0]


def tq_encode(x: torch.Tensor, bits: int, signs: torch.Tensor):
    """Rotate + per-vector scale + codebook encode -> (packed u8 codes,
    scale [...])."""
    return _encode(_rotate_padded(x, signs), bits)


def tq_decode(codes: torch.Tensor, scale: torch.Tensor, bits: int,
              signs: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    xn = _codebook(bits, codes.device)[unpack_codes(codes, bits).long()]
    return (hadamard_transform(xn * scale[..., None]) * signs).to(dtype)


def tq_decode_headdim(codes, scale, bits, signs, head_dim,
                      dtype=torch.float32):
    """tq_decode + slice back to the original (possibly non-pow2) head dim."""
    return tq_decode(codes, scale, bits, signs, dtype)[..., :head_dim]


def tq_encode_split(x: torch.Tensor, lo_bits: int, hi_bits: int, d_hi: int,
                    signs: torch.Tensor):
    """Outlier split in the rotated domain: the last `d_hi` rotated dims
    carry hi_bits codes, the rest lo_bits, each segment with its own
    per-token RMS scale -> (pa, sa, pb, sb)."""
    xr = _rotate_padded(x, signs)
    p2 = xr.shape[-1]
    pa, sa = _encode(xr[..., :p2 - d_hi], lo_bits)
    pb, sb = _encode(xr[..., p2 - d_hi:], hi_bits)
    return pa, sa, pb, sb


def tq_decode_split(pa, sa, pb, sb, lo_bits: int, hi_bits: int, signs,
                    head_dim: int, dtype=torch.float32) -> torch.Tensor:
    dev = pa.device
    xa = _codebook(lo_bits, dev)[unpack_codes(pa, lo_bits).long()] * sa[..., None]
    xb = _codebook(hi_bits, dev)[unpack_codes(pb, hi_bits).long()] * sb[..., None]
    out = hadamard_transform(torch.cat([xa, xb], dim=-1)) * signs
    return out[..., :head_dim].to(dtype)


def fused_route_on() -> bool:
    """The user's switch between the packed-code kernels (default) and the
    dequantize + sdpa route (MLX_VLM_TPU_TQ_FUSED=0 or false)."""
    return os.environ.get("MLX_VLM_TPU_TQ_FUSED", "1") not in ("0", "false")


def _write(codes, scales, new_codes, new_scales,
           offset: torch.Tensor) -> None:
    """Write S new tokens' (k, v) codes [B, H, S, w] and scales [B, H, S]
    at `offset`, in place."""
    cache_lib.update_layer(*codes, *new_codes, offset)
    cache_lib._update_scalar(*scales, *new_scales, offset)


def _group_rows(q_rot: torch.Tensor, nkv: int) -> torch.Tensor:
    """[B, nh, 1, p2] -> [B * nkv, g, p2] (the heads of one KV head)."""
    B, nh, _, p2 = q_rot.shape
    return q_rot.reshape(B * nkv, nh // nkv, p2)


def _ungroup(out: torch.Tensor, signs, B: int, nh: int, head_dim: int, dtype):
    """Kernel output [BH, g, p2] over rotated values -> [B, nh, 1, hd]."""
    out = hadamard_transform(out) * signs
    return out[..., :head_dim].reshape(B, nh, 1, head_dim).to(dtype)


@dataclasses.dataclass
class TurboQuantKVCache:
    """Rotation + codebook quantized KV cache.

    kq: u8 [L, B, H, C, p2*k_bits/8] packed codes; kscale f32 [L, B, H, C]
    (vq, vscale likewise).  Fractional kv_bits (e.g. 3.5) maps to 3-bit
    keys and 4-bit values."""

    kq: torch.Tensor
    kscale: torch.Tensor
    vq: torch.Tensor
    vscale: torch.Tensor
    offset: torch.Tensor
    left_pad: torch.Tensor
    k_bits: int
    v_bits: int
    head_dim: int

    @property
    def capacity(self) -> int:
        return self.kq.shape[3]

    def advance(self, new_tokens: int) -> None:
        self.offset.add_(new_tokens)

    def attend(self, layer: int, q, k, v, scale: float, mask,
               flash_ok: bool = True,
               logit_softcap: Optional[float] = None,
               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
        from ..ops.attention import sdpa
        from ..ops.tq_kv_attention import tq_kv_decode_attention

        kq, ksc = self.kq[layer], self.kscale[layer]
        vq, vsc = self.vq[layer], self.vscale[layer]
        p2 = _pow2(self.head_dim)
        signs = _signs(p2, q.device)
        nk, nks = tq_encode(k, self.k_bits, signs)
        nv, nvs = tq_encode(v, self.v_bits, signs)
        _write((kq, vq), (ksc, vsc), (nk, nv), (nks, nvs), self.offset)

        B, nh, S, _ = q.shape
        nkv, C = kq.shape[1], kq.shape[2]
        if (S == 1 and p2 % 8 == 0 and logit_softcap is None
                and sinks is None and fused_route_on()):
            BH = B * nkv
            out = tq_kv_decode_attention(
                _group_rows(_rotate_padded(q, signs), nkv),
                kq.reshape(BH, C, -1), ksc.reshape(BH, C),
                vq.reshape(BH, C, -1), vsc.reshape(BH, C),
                self.offset + S, scale, self.k_bits, self.v_bits,
                _codebook(self.k_bits, q.device),
                _codebook(self.v_bits, q.device),
                left_pad=self.left_pad.repeat_interleave(nkv))
            # probabilities were accumulated over rotated values: one
            # inverse rotation recovers the real-domain output
            return _ungroup(out, signs, B, nh, self.head_dim, q.dtype)
        k_full = tq_decode_headdim(kq, ksc, self.k_bits, signs,
                                   self.head_dim, q.dtype)
        v_full = tq_decode_headdim(vq, vsc, self.v_bits, signs,
                                   self.head_dim, q.dtype)
        return sdpa(q, k_full, v_full, scale, mask, logit_softcap, sinks)


def init_turboquant_cache(num_layers: int, batch_size: int,
                          num_kv_heads: int, head_dim: int, capacity: int,
                          kv_bits: float = 4.0,
                          left_pad: Optional[torch.Tensor] = None,
                          device=None) -> TurboQuantKVCache:
    """kv_bits may be fractional: 3.5 -> 3-bit keys, 4-bit values."""
    k_bits = int(np.floor(kv_bits))
    v_bits = int(np.ceil(kv_bits))
    if not (1 <= k_bits <= 8 and 1 <= v_bits <= 8):
        raise ValueError(f"unsupported kv_bits {kv_bits}")
    p2 = _pow2(head_dim)
    shape = (num_layers, batch_size, num_kv_heads, capacity)
    return TurboQuantKVCache(
        kq=torch.zeros((*shape, p2 * k_bits // 8), dtype=torch.uint8,
                       device=device),
        kscale=torch.zeros(shape, dtype=torch.float32, device=device),
        vq=torch.zeros((*shape, p2 * v_bits // 8), dtype=torch.uint8,
                       device=device),
        vscale=torch.zeros(shape, dtype=torch.float32, device=device),
        offset=cache_lib.new_cursor(device),
        left_pad=cache_lib.cursor(left_pad, batch_size, device),
        k_bits=k_bits, v_bits=v_bits, head_dim=head_dim)


@dataclasses.dataclass
class SplitTurboQuantKVCache:
    """Outlier-split rotated-codebook KV cache: fractional kv_bits as
    per-channel mixed precision.  The first DA = p2 - d_hi rotated dims
    carry lo_bits codes (kqa/vqa), the last d_hi carry hi_bits codes
    (kqb/vqb), each segment with its own per-token scale.  Decode runs
    the two-segment kernel K8 (ops/tq_kv_attention.py)."""

    kqa: torch.Tensor  # [L, B, H, C, DA*lo/8]
    ksa: torch.Tensor  # [L, B, H, C]
    kqb: torch.Tensor  # [L, B, H, C, DB*hi/8]
    ksb: torch.Tensor
    vqa: torch.Tensor
    vsa: torch.Tensor
    vqb: torch.Tensor
    vsb: torch.Tensor
    offset: torch.Tensor
    left_pad: torch.Tensor
    lo_bits: int
    hi_bits: int
    d_hi: int
    head_dim: int

    @property
    def capacity(self) -> int:
        return self.kqa.shape[3]

    def advance(self, new_tokens: int) -> None:
        self.offset.add_(new_tokens)

    def attend(self, layer: int, q, k, v, scale: float, mask,
               flash_ok: bool = True,
               logit_softcap: Optional[float] = None,
               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
        from ..ops.attention import sdpa
        from ..ops.tq_kv_attention import tq_kv_decode_attention_split

        kqa, ksa, kqb, ksb, vqa, vsa, vqb, vsb = (
            getattr(self, f)[layer] for f in (
                "kqa", "ksa", "kqb", "ksb", "vqa", "vsa", "vqb", "vsb"))
        p2 = _pow2(self.head_dim)
        signs = _signs(p2, q.device)
        nka, nksa, nkb, nksb = tq_encode_split(k, self.lo_bits, self.hi_bits,
                                               self.d_hi, signs)
        nva, nvsa, nvb, nvsb = tq_encode_split(v, self.lo_bits, self.hi_bits,
                                               self.d_hi, signs)
        _write((kqa, vqa), (ksa, vsa), (nka, nva), (nksa, nvsa), self.offset)
        _write((kqb, vqb), (ksb, vsb), (nkb, nvb), (nksb, nvsb), self.offset)

        B, nh, S, _ = q.shape
        nkv, C = kqa.shape[1], kqa.shape[2]
        da = p2 - self.d_hi
        if (S == 1 and da % 8 == 0 and self.d_hi % 8 == 0
                and logit_softcap is None and sinks is None
                and fused_route_on()):
            BH = B * nkv
            out = tq_kv_decode_attention_split(
                _group_rows(_rotate_padded(q, signs), nkv),
                kqa.reshape(BH, C, -1), ksa.reshape(BH, C),
                kqb.reshape(BH, C, -1), ksb.reshape(BH, C),
                vqa.reshape(BH, C, -1), vsa.reshape(BH, C),
                vqb.reshape(BH, C, -1), vsb.reshape(BH, C),
                self.offset + S, scale, self.lo_bits, self.hi_bits,
                _codebook(self.lo_bits, q.device),
                _codebook(self.hi_bits, q.device),
                left_pad=self.left_pad.repeat_interleave(nkv))
            return _ungroup(out, signs, B, nh, self.head_dim, q.dtype)
        k_full = tq_decode_split(kqa, ksa, kqb, ksb, self.lo_bits,
                                 self.hi_bits, signs, self.head_dim, q.dtype)
        v_full = tq_decode_split(vqa, vsa, vqb, vsb, self.lo_bits,
                                 self.hi_bits, signs, self.head_dim, q.dtype)
        return sdpa(q, k_full, v_full, scale, mask, logit_softcap, sinks)


def init_turboquant_split_cache(num_layers: int, batch_size: int,
                                num_kv_heads: int, head_dim: int,
                                capacity: int, kv_bits: float = 3.5,
                                left_pad: Optional[torch.Tensor] = None,
                                device=None) -> SplitTurboQuantKVCache:
    """Fractional kv_bits as a per-channel split: hi (ceil) bits on
    round(frac * p2 / 8) * 8 rotated dims, lo (floor) bits elsewhere."""
    lo = int(np.floor(kv_bits))
    hi = int(np.ceil(kv_bits))
    if lo == hi:
        raise ValueError("split codec needs a fractional kv_bits")
    p2 = _pow2(head_dim)
    d_hi = int(round((kv_bits - lo) * p2 / 8)) * 8  # Python's round, as in
    d_hi = max(8, min(p2 - 8, d_hi))                # the reference
    da = p2 - d_hi
    shape = (num_layers, batch_size, num_kv_heads, capacity)

    def codes(width):
        return torch.zeros((*shape, width), dtype=torch.uint8, device=device)

    def scales():
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return SplitTurboQuantKVCache(
        kqa=codes(da * lo // 8), ksa=scales(),
        kqb=codes(d_hi * hi // 8), ksb=scales(),
        vqa=codes(da * lo // 8), vsa=scales(),
        vqb=codes(d_hi * hi // 8), vsb=scales(),
        offset=cache_lib.new_cursor(device),
        left_pad=cache_lib.cursor(left_pad, batch_size, device),
        lo_bits=lo, hi_bits=hi, d_hi=d_hi, head_dim=head_dim)


# ---------------------------------------------------- rotated int4


def _rotate(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    return hadamard_transform(x.to(torch.float32) * signs).to(x.dtype)


def _unrotate(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    return (hadamard_transform(x.to(torch.float32)) * signs).to(x.dtype)


class RotatedInt4KVCache(cache_lib.Int4KVCache):
    """TurboQuant's rotation + the packed-domain int4 attend.

    K/V are stored in the rotated domain (sign flips + Walsh-Hadamard) as
    per-token affine 4-bit codes in the Int4KVCache half-plane layout.  The
    rotation R is orthogonal, so q.k = (Rq).(Rk) and sum_c p_c v_c =
    R^T sum_c p_c (R v_c): decode runs unchanged through K6
    (ops/int4_kv_attention.py) and one inverse rotation of the output
    recovers the real domain.  Needs a pow-2 head dim."""

    def attend(self, layer: int, q, k, v, scale: float, mask,
               flash_ok: bool = True,
               logit_softcap: Optional[float] = None,
               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
        signs = _signs(q.shape[-1], q.device)
        out = super().attend(layer, _rotate(q, signs), _rotate(k, signs),
                             _rotate(v, signs), scale, mask, flash_ok,
                             logit_softcap, sinks)
        return _unrotate(out, signs)


def make_rotated_int4_cache(num_layers, batch_size, num_kv_heads, head_dim,
                            capacity, left_pad=None, per_row=False,
                            device=None) -> RotatedInt4KVCache:
    """Build the rotated int4 cache (head_dim must be a power of 2); with
    `per_row` it has one cursor per row, the only TurboQuant cache the
    reference builds so (:599-608)."""
    if head_dim & (head_dim - 1):
        raise ValueError(
            f"rotated int4 cache needs a pow-2 head dim, got {head_dim}")
    base = cache_lib.init_int4_cache(num_layers, batch_size, num_kv_heads,
                                     head_dim, capacity, left_pad=left_pad,
                                     per_row=per_row, device=device)
    return RotatedInt4KVCache(**{f.name: getattr(base, f.name)
                                 for f in dataclasses.fields(base)})
