"""KV caches: fixed-capacity buffers written by index.

Port of mlx_vlm_tpu/core/cache.py (_flash_eligible :47, KVCache :79,
init_cache :149, update_layer :169, BatchKVCache :193, init_batch_cache
:224, update_layer_rows :241, update_layer_auto :259, insert_row :266,
QuantizedKVCache :301, init_quantized_cache :389, Int8KVCache :608,
_update_scalar_auto :743, init_int8_cache :762, Int4KVCache :795,
init_int4_cache :965).  A cache holds every layer's K and V in
preallocated buffers [L, B, n_kv_heads, capacity, ...]; rows share one
write cursor `offset`, an int32 0-dim tensor on the cache's device as the
reference's is (:83-89), and mask their unused prefix with `left_pad`.  A
cache built with `per_row=True` (and `BatchKVCache`, the continuous-
batching cache) has one cursor per row instead, an int32 [B] tensor on the
device, written by index (`insert_row`) and never read on the host.
Unlike the reference's immutable arrays, writes happen IN PLACE at rows
offset + arange(S) (each row at its own cursor for a [B] cursor), by
index: `update_layer` and each cache's `attend(layer, q, k, v, scale,
mask, flash_ok=True, logit_softcap=None, sinks=None)` mutate the buffers
they are given, and `advance` adds to the cursor in place.  As in the
reference, `flash_ok` False keeps a prefill chunk off K4 (a decoder whose
mask K4 cannot express), and a soft-cap (gemma2's) or attention sinks
(gpt-oss's, :132, :719-722, :889, :946-948) keep every kernel off: K4 and
K6 take neither, so such scores go through the plain routes (`sdpa`,
`_integer_attend`).  Nothing here reads the cursor on the host,
so a decode step can be captured in a CUDA graph and replayed; the
capacity is checked by the caller, which knows every position it will
write (generate/ar.py `check_capacity`, generate/batch.py's cap on
`max_tokens`).

The group-affine QuantizedKVCache stores mlx-style codes along the head dim
(the `quantize` / `dequantize` of QuantizedTensor) and attends by
dequantizing the whole layer, in plain PyTorch, as the reference does in
XLA.  The other quantized caches keep one affine scale and bias per (row,
head, token),
so the scale factors out of the head-dim reduction and attention runs on
the integer codes.  Their prefill (S > 1) is plain PyTorch, as the
reference's is XLA; a 4-bit decode step runs K6
(ops/int4_kv_attention.py).  Integer dots are taken in f32, which is exact
here (|sum| < 2**24 for head dims up to 256), because CUDA has no int8
einsum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.attention import softmax_with_sinks
from .quant import (QuantizedTensor, _check_bits, dequantize, dtype_name,
                    quantize)

__all__ = ["KVCache", "init_cache", "update_layer", "flash_eligible",
           "new_cursor", "BatchKVCache", "init_batch_cache",
           "update_layer_rows", "insert_row", "snapshot", "restore",
           "row_view",
           "QuantizedKVCache", "init_quantized_cache", "Int8KVCache",
           "init_int8_cache", "Int4KVCache", "init_int4_cache"]

_F32_MIN = float(torch.finfo(torch.float32).min)


def flash_eligible(q: torch.Tensor, k_buf: torch.Tensor) -> bool:
    """Route a prefill chunk to the flash-attention kernel (K4).

    The reference's rule with "tensor is on CUDA" in place of its TPU check:
    S >= 256 query rows, capacity C >= 8192 and a multiple of 128; and,
    decided by shape as the rest, the head size K4 takes (HEAD_DIM, 128).
    The reference's kernel takes any head size; the port's other sizes go to
    `sdpa` (ROADMAP Queue 3, divergences).  A dtype the kernel does not take
    makes `flash_attention` raise; it is not rerouted to `sdpa`."""
    from ..ops.flash_attention import HEAD_DIM

    if q.device.type != "cuda":
        return False
    S, C, D = q.shape[2], k_buf.shape[2], q.shape[-1]
    return S >= 256 and C >= 8192 and C % 128 == 0 and D == HEAD_DIM


def new_cursor(device=None, rows: Optional[int] = None) -> torch.Tensor:
    """A cache's write cursor at 0: an int32 0-dim tensor on `device`, or
    one per row (int32 [rows]) for a per-row cache."""
    shape = () if rows is None else (rows,)
    return torch.zeros(shape, dtype=torch.int32, device=device)


def update_layer(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 offset: torch.Tensor):
    """Write S new tokens at rows offset + arange(S) of one layer's
    [B, H, C, ...] buffers, in place, by index (the cursor is never read on
    the host); a per-row cursor [B] writes each row at its own
    (`update_layer_rows`, the reference's update_layer_auto).  The caller
    checks the capacity first; a row past C raises on the CPU and faults
    on the card, it is never clamped."""
    if offset.dim() == 1:
        return update_layer_rows(k_cache, v_cache, k_new, v_new, offset)
    rows = offset.long() + torch.arange(k_new.shape[2], device=offset.device)
    k_cache.index_copy_(2, rows, k_new.to(k_cache.dtype))
    v_cache.index_copy_(2, rows, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def update_layer_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      offsets: torch.Tensor):
    """Write row b's S new tokens at offsets[b] + arange(S) of one layer's
    [B, H, C, ...] buffers, in place: one scatter along the token axis per
    buffer (the reference's vmapped dynamic_update_slice)."""
    B, H, S = k_new.shape[:3]
    rows = offsets.long()[:, None] + torch.arange(S, device=offsets.device)
    rows = rows[:, None, :]
    for buf, new in ((k_cache, k_new), (v_cache, v_new)):
        idx = rows.reshape(B, 1, S, *(1,) * (new.dim() - 3))
        buf.scatter_(2, idx.expand(new.shape), new.to(buf.dtype))
    return k_cache, v_cache


def _update_scalar(a_cache: torch.Tensor, b_cache: torch.Tensor,
                   a_new: torch.Tensor, b_new: torch.Tensor,
                   offset: torch.Tensor):
    """Write per-token scalars [B, H, S] at `offset` into [B, H, C] buffers,
    in place, by index (the reference's _update_scalar_auto): at one shared
    cursor, or each row at its own."""
    return update_layer(a_cache[..., None], b_cache[..., None],
                        a_new[..., None], b_new[..., None], offset)


def cursor(left_pad: Optional[torch.Tensor], batch_size: int,
           device) -> torch.Tensor:
    """The cache's left_pad: int32 [B] on `device` (zeros by default)."""
    if left_pad is None:
        return torch.zeros((batch_size,), dtype=torch.int32, device=device)
    return left_pad.to(device=device, dtype=torch.int32)


def set_prompt_end(cache, end) -> None:
    """Record where the prompt ends in `cache` before a padded prefill (an
    int, or int [B] for right-padded rows), as an int32 tensor on the
    cache's device.  A decoder with a bidirectional prefix stops its
    prefix mask there, so that no prompt row sees the prefill's padding;
    the causal decoders never read it.  An attribute, not a field: a
    snapshot, a row view or a restored cache does not carry it."""
    cache.prompt_end = torch.as_tensor(end, dtype=torch.int32).to(
        cache.left_pad.device)


@dataclasses.dataclass
class KVCache:
    """All-layer KV cache.

    k, v:     [L, B, n_kv_heads, capacity, head_dim]
    offset:   tokens written so far: the shared write cursor, an int32
              0-dim tensor on the cache's device
    left_pad: int32 [B] on the cache's device
    """

    k: torch.Tensor
    v: torch.Tensor
    offset: torch.Tensor
    left_pad: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    def advance(self, new_tokens: int) -> None:
        self.offset.add_(new_tokens)

    def attend(self, layer: int, q, k, v, scale: float, mask,
               flash_ok: bool = True,
               logit_softcap: Optional[float] = None,
               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Write this layer's new k/v at `offset` (in place) and attend.

        Prefill chunks that pass `flash_eligible` go through the flash
        kernel, when `flash_ok` and neither a soft-cap nor sinks; decode
        and other shapes use `sdpa` with `mask`."""
        from ..ops.attention import sdpa

        k_buf, v_buf = self.k[layer], self.v[layer]
        update_layer(k_buf, v_buf, k, v, self.offset)
        if (flash_ok and logit_softcap is None and sinks is None
                and flash_eligible(q, k_buf)):
            from ..ops.flash_attention import flash_attention

            off = self.offset.expand(q.shape[0])
            return flash_attention(q, k_buf, v_buf, off, self.left_pad, scale)
        return sdpa(q, k_buf, v_buf, scale, mask, logit_softcap, sinks)


def init_cache(num_layers: int, batch_size: int, num_kv_heads: int,
               head_dim: int, capacity: int, dtype=torch.bfloat16,
               left_pad: Optional[torch.Tensor] = None,
               device=None) -> KVCache:
    shape = (num_layers, batch_size, num_kv_heads, capacity, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        offset=new_cursor(device),
        left_pad=cursor(left_pad, batch_size, device),
    )


@dataclasses.dataclass
class BatchKVCache(KVCache):
    """Continuous-batching cache: one write cursor per row.

    Rows live in fixed slots; `offset[b]` (int32 [B] on the device) counts
    the valid tokens of row b, and `insert_row` recycles a slot without
    touching the others.  Its own class, as in the reference, so the fused
    decode route (which takes a plain `KVCache` only) never takes it, even
    with one slot.  `advance` adds to every row; generate/batch.py takes
    the step back from the rows that were idle."""


def init_batch_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                     head_dim: int, capacity: int, dtype=torch.bfloat16,
                     device=None) -> BatchKVCache:
    shape = (num_layers, batch_size, num_kv_heads, capacity, head_dim)
    return BatchKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        offset=new_cursor(device, batch_size),
        left_pad=cursor(None, batch_size, device),
    )


def cache_buffers(cache) -> list:
    """A cache's per-layer buffers [L, B, H, C, ...], in field order (every
    tensor field but the cursor and left_pad)."""
    return [getattr(cache, f.name) for f in dataclasses.fields(cache)
            if f.name not in ("offset", "left_pad")
            and isinstance(getattr(cache, f.name), torch.Tensor)]


def _map_tensors(obj, fn):
    """`obj` with `fn` applied to every tensor it holds: a cache
    dataclass's fields (other fields kept), dict values, list and tuple
    items."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def snapshot(cache):
    """A host copy of a cache: every buffer of `cache_buffers`, the cursor
    and left_pad copied to CPU tensors (the reference's
    `jax.device_get(cache)`).  Always a copy, also of a CPU cache, whose
    `.cpu()` would alias the buffers that the next decode step writes in
    place.  The copy from the card waits for it."""
    return _map_tensors(cache, lambda t: t.detach().to("cpu", copy=True))


def restore(snap, device):
    """A cache of fresh tensors on `device` from a `snapshot` (the
    reference's `tree_map(jnp.asarray, snap)`): always a copy, so that
    the snapshot stays as it was stored while the restored cache is
    written."""
    return _map_tensors(snap, lambda t: t.to(device, copy=True))


def row_view(cache, row: int, offset: int):
    """One row of a multi-row cache as a cache of the same class: its
    buffers' row `row` (views, no copy), a new 0-dim cursor at `offset`
    and its left_pad (the reference's one-row harvest view, batch.py
    :367-375)."""
    bufs = {f.name: getattr(cache, f.name)[:, row:row + 1]
            for f in dataclasses.fields(cache)
            if f.name not in ("offset", "left_pad")
            and isinstance(getattr(cache, f.name), torch.Tensor)}
    return dataclasses.replace(
        cache, **bufs, left_pad=cache.left_pad[row:row + 1],
        offset=torch.full((), offset, dtype=torch.int32,
                          device=cache.left_pad.device))


def insert_row(batch, row, slot: int, prompt_len: int,
               src_row: int = 0) -> None:
    """Copy rows [0, cp) of row `src_row` of a prefilled cache into slot
    `slot` of `batch`, a per-row cache of the same class, IN PLACE (a
    captured decode step keeps reading the same buffers), cp being the
    smaller capacity; set the slot's cursor to `prompt_len` and its
    left_pad to 0.  Code planes [L, B, H, C, w] and per-token planes
    [L, B, H, C] alike (the reference's rank-generic copy, :285-288)."""
    for b_buf, r_buf in zip(cache_buffers(batch), cache_buffers(row)):
        cp = min(r_buf.shape[3], b_buf.shape[3])
        b_buf[:, slot, :, :cp].copy_(r_buf[:, src_row, :, :cp])
    batch.offset[slot] = prompt_len
    batch.left_pad[slot] = 0


@dataclasses.dataclass
class QuantizedKVCache:
    """Group-affine quantized KV cache (1, 2, 4 or 8 bits along head_dim).

    kq, vq: uint8 [L, B, H, C, D * bits / 8] packed codes (low bits first)
    ks/kb, vs/vb: [L, B, H, C, D / group_size] scales / biases in the model
    dtype (dequant = code * s + b per group)

    `attend` quantizes the new k/v, writes them at `offset` in place,
    dequantizes the whole layer and runs `sdpa`: the reference's XLA route
    (it has no kernel for this cache)."""

    kq: torch.Tensor
    ks: torch.Tensor
    kb: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor
    vb: torch.Tensor
    offset: torch.Tensor
    left_pad: torch.Tensor
    bits: int
    group_size: int

    @property
    def capacity(self) -> int:
        return self.kq.shape[3]

    def advance(self, new_tokens: int) -> None:
        self.offset.add_(new_tokens)

    def _dequantize(self, q, s, b, dtype) -> torch.Tensor:
        t = QuantizedTensor(q=q, scales=s, biases=b, bits=self.bits,
                            group_size=self.group_size,
                            out_dtype=dtype_name(s))
        return dequantize(t, dtype)

    def attend(self, layer: int, q, k, v, scale: float, mask,
               flash_ok: bool = True,
               logit_softcap: Optional[float] = None,
               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
        from ..ops.attention import sdpa

        kq, ks, kb = self.kq[layer], self.ks[layer], self.kb[layer]
        vq, vs, vb = self.vq[layer], self.vs[layer], self.vb[layer]
        kn = quantize(k, bits=self.bits, group_size=self.group_size)
        vn = quantize(v, bits=self.bits, group_size=self.group_size)
        update_layer(kq, vq, kn.q, vn.q, self.offset)
        update_layer(ks, vs, kn.scales, vn.scales, self.offset)
        update_layer(kb, vb, kn.biases, vn.biases, self.offset)
        k_full = self._dequantize(kq, ks, kb, q.dtype)
        v_full = self._dequantize(vq, vs, vb, q.dtype)
        return sdpa(q, k_full, v_full, scale, mask, logit_softcap, sinks)


def init_quantized_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                         head_dim: int, capacity: int, dtype=torch.bfloat16,
                         bits: int = 8, group_size: int = 64,
                         left_pad: Optional[torch.Tensor] = None,
                         per_row: bool = False,
                         device=None) -> QuantizedKVCache:
    """Zeroed group-affine cache; raises for bits or a group size that
    `quantize` does not take (the reference raises the same errors at the
    first write)."""
    _check_bits(bits)
    if head_dim % group_size:
        raise ValueError(f"last dim {head_dim} not divisible by group_size "
                         f"{group_size}")
    base = (num_layers, batch_size, num_kv_heads, capacity)
    packed = (*base, head_dim * bits // 8)
    groups = (*base, head_dim // group_size)
    return QuantizedKVCache(
        kq=torch.zeros(packed, dtype=torch.uint8, device=device),
        ks=torch.zeros(groups, dtype=dtype, device=device),
        kb=torch.zeros(groups, dtype=dtype, device=device),
        vq=torch.zeros(packed, dtype=torch.uint8, device=device),
        vs=torch.zeros(groups, dtype=dtype, device=device),
        vb=torch.zeros(groups, dtype=dtype, device=device),
        offset=new_cursor(device, batch_size if per_row else None),
        left_pad=cursor(left_pad, batch_size, device), bits=bits,
        group_size=group_size)


def quantize_query(q: torch.Tensor):
    """Symmetric per-(b, head, s) int8 query codes for the score dot:
    (q8 as f32 integers, qs [B, nh, S], qsum = sum(q8) [B, nh, S])."""
    qf = q.to(torch.float32)
    qs = qf.abs().amax(dim=-1) / 127.0
    qs = torch.where(qs == 0.0, torch.ones_like(qs), qs)
    q8 = torch.round(qf / qs[..., None])
    return q8, qs, q8.sum(dim=-1)


def _integer_attend(q8, qs, qsum, k_codes, ks, kb, v_codes, vs, vb,
                    scale: float, mask, dtype,
                    logit_softcap: Optional[float] = None,
                    sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's integer-domain attend (Int8KVCache.attend and
    Int4KVCache's XLA route): per-token affine codes, scores
    qs * (ks * (q8 . k) + kb * sum(q8)) * scale, soft-capped when asked,
    masked to f32 min, a plain softmax (with the sinks' column when given,
    :719-722), the value scale folded into the probabilities (rounded to
    `dtype`) and the value bias added as a rank-1 term.

    q8/qs/qsum from quantize_query; k/v codes [B, nkv, C, D] as f32
    integers; scales and biases [B, nkv, C].  Returns [B, nh, S, D]."""
    B, nh, S, D = q8.shape
    nkv = k_codes.shape[1]
    g = nh // nkv
    iscores = torch.einsum("bkgsd,bktd->bkgst", q8.reshape(B, nkv, g, S, D),
                           k_codes)
    scores = ((iscores * ks[:, :, None, None, :]
               + qsum.reshape(B, nkv, g, S, 1) * kb[:, :, None, None, :])
              * qs.reshape(B, nkv, g, S, 1) * scale)
    if logit_softcap is not None:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if mask is not None:
        m = mask
        if m.dim() == 4:
            m = (m.reshape(B, nkv, g, S, -1) if m.shape[1] == nh
                 else m[:, :, None])
        scores = scores.masked_fill(~m, _F32_MIN)
    p = softmax_with_sinks(scores, sinks)
    pv = (p * vs[:, :, None, None, :]).to(dtype).float()
    out = torch.einsum("bkgst,bktd->bkgsd", pv, v_codes.to(dtype).float())
    out = out + torch.einsum("bkgst,bkt->bkgs", p, vb)[..., None]
    return out.reshape(B, nh, S, D).to(dtype)


def _affine_tokens(x: torch.Tensor, levels: int):
    """Per-token affine codes of x [B, H, S, D]: (codes in [0, levels] as
    f32, scale, min)."""
    xf = x.to(torch.float32)
    mn = xf.amin(dim=-1)
    s = (xf.amax(dim=-1) - mn) / float(levels)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round((xf - mn[..., None]) / s[..., None]), 0,
                    levels)
    return q, s, mn


@dataclasses.dataclass
class Int8KVCache:
    """Per-token-scale int8 KV cache with an integer-domain attend.

    k8, v8: int8 [L, B, H, C, D] (codes shifted by -128)
    ks/kb, vs/vb: f32 [L, B, H, C] per-token scale / bias (dequant =
    k8 * s + b, the bias being min + 128 * s)

    It has no kernel of its own: prefill and decode run `_integer_attend`
    in plain PyTorch, as the reference's run in XLA."""

    k8: torch.Tensor
    ks: torch.Tensor
    kb: torch.Tensor
    v8: torch.Tensor
    vs: torch.Tensor
    vb: torch.Tensor
    offset: torch.Tensor
    left_pad: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k8.shape[3]

    def advance(self, new_tokens: int) -> None:
        self.offset.add_(new_tokens)

    @staticmethod
    def _quantize_tokens(x: torch.Tensor):
        """[B,H,S,D] -> (int8 codes, scale [B,H,S], bias [B,H,S])."""
        q, s, mn = _affine_tokens(x, 255)
        return (q - 128.0).to(torch.int8), s, mn + 128.0 * s

    def attend(self, layer: int, q, k, v, scale: float, mask,
               flash_ok: bool = True,
               logit_softcap: Optional[float] = None,
               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
        k8, ks, kb = self.k8[layer], self.ks[layer], self.kb[layer]
        v8, vs, vb = self.v8[layer], self.vs[layer], self.vb[layer]
        kn8, kns, knb = self._quantize_tokens(k)
        vn8, vns, vnb = self._quantize_tokens(v)
        update_layer(k8, v8, kn8, vn8, self.offset)
        _update_scalar(ks, vs, kns, vns, self.offset)
        _update_scalar(kb, vb, knb, vnb, self.offset)
        q8, qs, qsum = quantize_query(q)
        return _integer_attend(q8, qs, qsum, k8.float(), ks, kb, v8.float(),
                               vs, vb, scale, mask, q.dtype, logit_softcap,
                               sinks)


def _cache_planes(num_layers, batch_size, num_kv_heads, capacity, width,
                  code_dtype, device) -> dict:
    """Zeroed code planes [L, B, H, C, width] and f32 per-token planes."""
    base = (num_layers, batch_size, num_kv_heads, capacity)
    planes = {}
    for side in "kv":
        planes[side] = torch.zeros((*base, width), dtype=code_dtype,
                                   device=device)
        for f in "sb":
            planes[side + f] = torch.zeros(base, dtype=torch.float32,
                                           device=device)
    return planes


def init_int8_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                    head_dim: int, capacity: int,
                    left_pad: Optional[torch.Tensor] = None,
                    per_row: bool = False, device=None) -> Int8KVCache:
    p = _cache_planes(num_layers, batch_size, num_kv_heads, capacity,
                      head_dim, torch.int8, device)
    return Int8KVCache(k8=p["k"], ks=p["ks"], kb=p["kb"], v8=p["v"],
                       vs=p["vs"], vb=p["vb"],
                       offset=new_cursor(device,
                                         batch_size if per_row else None),
                       left_pad=cursor(left_pad, batch_size, device))


def int4_kv_route(S: int, D: int, logit_softcap: Optional[float] = None,
                  sinks: Optional[torch.Tensor] = None) -> bool:
    """A 4-bit cache's attend runs K6 for a decode step (S == 1) with a head
    dim that is a multiple of 8, so that each token's D/2 code bytes are
    whole 32-bit words for the kernel, and neither a soft-cap nor sinks
    (the kernel takes neither; the reference's rule refuses both, :889);
    other steps take the integer-domain attend (`_integer_attend`).  The
    reference's own rule ((D/2) % 128 == 0,
    C % 128 == 0, g * S <= 8: cache.py:887-892), which sends even D = 128
    to that route, holds Mosaic tiling and row padding limits of its TPU
    kernel, which the port's kernel does not have."""
    return (S == 1 and D % 8 == 0 and logit_softcap is None
            and sinks is None)


@dataclasses.dataclass
class Int4KVCache:
    """Per-token-scale 4-bit KV cache with a packed-domain attend.

    Codes pack along the head dim in two half planes (channels [0, D/2) in
    the low nibble, [D/2, D) in the high nibble):

    k4, v4: u8 [L, B, H, C, D/2]
    ks/kb, vs/vb: f32 [L, B, H, C] per-token scale / bias (dequant =
    code * s + b, codes 0..15)

    A decode step runs K6 (ops/int4_kv_attention.py) on the packed codes,
    unless a soft-cap or sinks keep it off (`int4_kv_route`); prefill takes
    the integer-domain attend with the unpack materialized (the reference's
    XLA route)."""

    k4: torch.Tensor
    ks: torch.Tensor
    kb: torch.Tensor
    v4: torch.Tensor
    vs: torch.Tensor
    vb: torch.Tensor
    offset: torch.Tensor
    left_pad: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k4.shape[3]

    def advance(self, new_tokens: int) -> None:
        self.offset.add_(new_tokens)

    @staticmethod
    def _quantize_tokens(x: torch.Tensor):
        """[B,H,S,D] -> (packed u8 [B,H,S,D/2], scale [B,H,S], bias)."""
        q, s, mn = _affine_tokens(x, 15)
        q = q.to(torch.uint8)
        h = x.shape[-1] // 2
        return q[..., :h] | (q[..., h:] << 4), s, mn

    @staticmethod
    def _unpack(p4: torch.Tensor) -> torch.Tensor:
        """u8 [..., D/2] -> codes [..., D] as f32 (half-plane order)."""
        return torch.cat([p4 & 0xF, p4 >> 4], dim=-1).float()

    def attend(self, layer: int, q, k, v, scale: float, mask,
               flash_ok: bool = True,
               logit_softcap: Optional[float] = None,
               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
        from ..ops.int4_kv_attention import int4_kv_decode_attention

        k4, ks, kb = self.k4[layer], self.ks[layer], self.kb[layer]
        v4, vs, vb = self.v4[layer], self.vs[layer], self.vb[layer]
        kn4, kns, knb = self._quantize_tokens(k)
        vn4, vns, vnb = self._quantize_tokens(v)
        update_layer(k4, v4, kn4, vn4, self.offset)
        _update_scalar(ks, vs, kns, vns, self.offset)
        _update_scalar(kb, vb, knb, vnb, self.offset)

        B, nh, S, D = q.shape
        nkv, C = k4.shape[1], k4.shape[2]
        q8, qs, qsum = quantize_query(q)
        if not int4_kv_route(S, D, logit_softcap, sinks):
            return _integer_attend(q8, qs, qsum, self._unpack(k4), ks, kb,
                                   self._unpack(v4), vs, vb, scale, mask,
                                   q.dtype, logit_softcap, sinks)
        BH, g = B * nkv, nh // nkv
        off = self.offset + S
        if off.dim() == 1:  # per-row cursors: one per (row, KV head)
            off = off.repeat_interleave(nkv)
        out = int4_kv_decode_attention(
            q8.to(torch.int8).reshape(BH, g, D),
            torch.stack([qsum.reshape(BH, g), qs.reshape(BH, g)], dim=-1),
            k4.reshape(BH, C, D // 2), ks.reshape(BH, C), kb.reshape(BH, C),
            v4.reshape(BH, C, D // 2), vs.reshape(BH, C), vb.reshape(BH, C),
            off, scale, left_pad=self.left_pad.repeat_interleave(nkv))
        return out.reshape(B, nh, S, D).to(q.dtype)


def init_int4_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                    head_dim: int, capacity: int,
                    left_pad: Optional[torch.Tensor] = None,
                    per_row: bool = False, device=None) -> Int4KVCache:
    p = _cache_planes(num_layers, batch_size, num_kv_heads, capacity,
                      head_dim // 2, torch.uint8, device)
    return Int4KVCache(k4=p["k"], ks=p["ks"], kb=p["kb"], v4=p["v"],
                       vs=p["vs"], vb=p["vb"],
                       offset=new_cursor(device,
                                         batch_size if per_row else None),
                       left_pad=cursor(left_pad, batch_size, device))
