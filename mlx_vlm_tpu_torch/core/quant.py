"""Group-affine weight quantization: the layouts the slice loads into.

Port of mlx_vlm_tpu/core/quant.py (QuantizedTensor :38, ChannelQuantizedTensor
:77, to_channel_quantized :114, channel_quantized_matmul :173, quantize
:188, dequantize :234, quantized_matmul :246, from_mlx_packed :279,
Int4GroupedTensor :484, _int4_half_width :526, to_int4_grouped :537,
int4_grouped_dequantize :574).

Layouts stay bit-exact with the reference: the mlx uint32 words are re-viewed
as bytes, and the halves-packed int4 repack runs on the host in numpy, as in
the reference (torch has few uint32 operations); the per-channel int8
requantization (w8chan) runs as torch float64 ops on the load's device.
Containers hold numpy arrays while on the host and torch tensors once
loaded on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "QuantizedTensor",
    "ChannelQuantizedTensor",
    "Int4GroupedTensor",
    "quantize",
    "dequantize",
    "quantized_matmul",
    "qmm_kernel_route",
    "channel_quantized_matmul",
    "from_mlx_packed",
    "to_channel_quantized",
    "to_int4_grouped",
    "int4_grouped_dequantize",
    "host_array",
    "dtype_name",
]


def dtype_name(a) -> str:
    """'bfloat16', 'float32', ... for a numpy array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return np.asarray(a).dtype.name


def host_array(a, dtype=None) -> np.ndarray:
    """A host numpy copy or view of `a`; bfloat16 widens exactly to float32.

    Accepts torch tensors and numpy arrays, including numpy arrays of the
    `ml_dtypes` bfloat16 type (read by dtype name, so ml_dtypes is not
    imported here)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        a = a.numpy()
    else:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a if dtype is None else a.astype(dtype, copy=False)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass
class QuantizedTensor:
    """A group-affine quantized 2-D (or stacked 3-D) weight.

    q:      uint8, packed along the last axis (bits=4: two elements per byte,
            low nibble = even index; bits=8: one per byte)
    scales, biases: [..., groups]; w ~= scales * q + biases per group
    """

    q: object
    scales: object
    biases: object
    bits: int
    group_size: int
    out_dtype: str

    @property
    def shape(self):
        *lead, packed = self.q.shape
        return tuple(lead) + (packed * (8 // self.bits),)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.out_dtype)

    @property
    def ndim(self):
        return len(self.q.shape)

    def layer(self, i: int) -> "QuantizedTensor":
        """Layer `i` of a stacked [L, N, K*bits/8] weight, as views."""
        return dataclasses.replace(self, q=self.q[i], scales=self.scales[i],
                                   biases=self.biases[i])


@dataclasses.dataclass
class ChannelQuantizedTensor:
    """Per-output-channel affine int8 weight in transposed [.., K, N] layout.

    q8:     int8 [.., K, N] (codes shifted by -128)
    scales: [.., 1, N] in out_dtype
    biases: [.., 1, N] in out_dtype (includes the +128 * s shift)
    """

    q8: object
    scales: object
    biases: object
    src_bits: int
    out_dtype: str

    @property
    def shape(self):
        *lead, k, n = self.q8.shape
        return tuple(lead) + (n, k)  # logical HF [out, in] view

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.out_dtype)

    @property
    def ndim(self):
        return len(self.q8.shape)

    def layer(self, i: int) -> "ChannelQuantizedTensor":
        """Layer `i` of a stacked [L, K, N] weight, as views."""
        return dataclasses.replace(self, q8=self.q8[i], scales=self.scales[i],
                                   biases=self.biases[i])


@dataclasses.dataclass
class Int4GroupedTensor:
    """Group-affine int4 weight in the halves-packed kernel layout.

    qp:    uint8 [.., K, N2p]; byte [k, j] holds code(col j) in the low nibble
           and code(col N2p + j) in the high nibble; columns >= n are zero
    sl/sh: float32 [.., G, 1, N2p] scales of the low/high planes
    bl/bh: float32 [.., G, 1, N2p] affine biases of the low/high planes
    n: logical output features; group_size: along K
    """

    qp: object
    sl: object
    sh: object
    bl: object
    bh: object
    n: int = 0
    group_size: int = 64
    out_dtype: str = "bfloat16"

    @property
    def shape(self):
        *lead, k, _ = self.qp.shape
        return tuple(lead) + (self.n, k)  # logical HF [out, in]

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.out_dtype)

    @property
    def ndim(self):
        return len(self.qp.shape)

    def layer(self, i: int) -> "Int4GroupedTensor":
        """Layer `i` of a stacked [L, K, N2p] weight, as views (no copy)."""
        return dataclasses.replace(
            self, qp=self.qp[i], sl=self.sl[i], sh=self.sh[i], bl=self.bl[i],
            bh=self.bh[i])


def to_channel_quantized(t: QuantizedTensor, chunk_rows: int = 8192,
                         device=None) -> ChannelQuantizedTensor:
    """Requantize a group-affine [N, K] tensor to per-channel int8 [K, N],
    as torch float64 ops on `device` (the CPU when None): the load's
    device, so that a load onto the card folds there.

    Exact dequant of the source (float64: codes * scale, then + bias, two
    roundings as the reference's numpy takes them), then per output row:
    q8 = round((w - min_n) / s_n) - 128 (round half to even, clipped to
    [0, 255]) with s_n = (max_n - min_n) / 255 (1 where that is 0), and the
    bias min_n + 128 * s_n; scales and biases cast to the output dtype on
    the device.  Rows are independent, so they are processed `chunk_rows`
    at a time to bound memory on vocab-sized tables; the result does not
    depend on it, and is byte for byte the reference's host fold
    (reference core/quant.py:114) on either device."""
    dev = torch.device("cpu" if device is None else device)
    q = t.q if isinstance(t.q, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(host_array(t.q)))
    if q.ndim != 2:
        raise ValueError("to_channel_quantized takes a 2-D weight")
    q = q.to(dev, torch.uint8)

    def f64(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(dev, torch.float64)
        return torch.from_numpy(host_array(a, np.float64)).to(dev)

    scales, biases = f64(t.scales), f64(t.biases)
    per_byte = 8 // t.bits
    mask = (1 << t.bits) - 1
    g = t.group_size
    N = q.shape[0]
    K = q.shape[1] * per_byte
    q8 = torch.empty((K, N), dtype=torch.int8, device=dev)
    s_out = torch.empty((1, N), dtype=torch.float64, device=dev)
    b_out = torch.empty((1, N), dtype=torch.float64, device=dev)
    for r0 in range(0, N, chunk_rows):
        r1 = min(N, r0 + chunk_rows)
        qc = q[r0:r1]
        if per_byte > 1:
            parts = [(qc >> (t.bits * j)) & mask for j in range(per_byte)]
            qc = torch.stack(parts, dim=-1).reshape(r1 - r0, K)
        w = qc.reshape(r1 - r0, K // g, g).to(torch.float64)
        w = w * scales[r0:r1, :, None]
        w = w + biases[r0:r1, :, None]
        w = w.reshape(r1 - r0, K)
        mn = w.amin(dim=-1, keepdim=True)
        mx = w.amax(dim=-1, keepdim=True)
        # a tensor divisor: PyTorch's CUDA division by a scalar multiplies
        # by its reciprocal, which is not the reference's quotient
        s = (mx - mn) / torch.full_like(mx, 255.0)
        s = torch.where(s == 0.0, torch.ones_like(s), s)
        codes = torch.clamp(torch.round((w - mn) / s), 0, 255) - 128.0
        q8[:, r0:r1] = codes.T.to(torch.int8)
        s_out[0, r0:r1] = s[:, 0]
        b_out[0, r0:r1] = (mn + 128.0 * s)[:, 0]
    dt = torch_dtype(t.out_dtype)
    return ChannelQuantizedTensor(
        q8=q8,
        scales=s_out.to(dt),
        biases=b_out.to(dt),
        src_bits=t.bits,
        out_dtype=t.out_dtype,
    )


def channel_quantized_matmul(x: torch.Tensor,
                             t: ChannelQuantizedTensor) -> torch.Tensor:
    """x [..., K] @ dequant(t).T -> [..., N]: the weight dequantized in x's
    dtype (q8 * s + b over [K, N]), then one product in x's dtype with f32
    accumulation, as the reference leaves it to XLA."""
    dt = x.dtype
    w = t.q8.to(dt) * t.scales.to(dt) + t.biases.to(dt)
    return torch.matmul(x, w)


def _check_bits(bits: int):
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"Only 1/2/4/8-bit quantization supported, got {bits}")


def quantize(w: torch.Tensor, bits: int = 4,
             group_size: int = 64) -> QuantizedTensor:
    """Affine-quantize `w` along its last axis (mlx-compatible semantics).

    For each group: q = round((w - min) / scale), w ~= scale * q + min."""
    _check_bits(bits)
    *lead, n = w.shape
    if n % group_size:
        raise ValueError(f"last dim {n} not divisible by group_size {group_size}")
    wf = w.float().reshape(*lead, n // group_size, group_size)
    wmax = wf.amax(dim=-1)
    wmin = wf.amin(dim=-1)
    qmax = float(2**bits - 1)
    scale = (wmax - wmin) / qmax
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round((wf - wmin[..., None]) / scale[..., None]),
                    0, qmax)
    q = q.to(torch.uint8).reshape(*lead, n)
    per_byte = 8 // bits
    if per_byte > 1:
        packed = torch.zeros((*lead, n // per_byte), dtype=torch.uint8,
                             device=w.device)
        for j in range(per_byte):
            packed = packed | (q[..., j::per_byte] << (bits * j))
        q = packed
    return QuantizedTensor(
        q=q,
        scales=scale.to(w.dtype),
        biases=wmin.to(w.dtype),
        bits=bits,
        group_size=group_size,
        out_dtype=dtype_name(w),
    )


def _unpack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 packed -> uint8 elements in [0, 2^bits)."""
    if bits == 8:
        return q
    per_byte = 8 // bits
    mask = (1 << bits) - 1
    parts = [(q >> (bits * j)) & mask for j in range(per_byte)]
    out = torch.stack(parts, dim=-1)
    return out.reshape(*q.shape[:-1], q.shape[-1] * per_byte)


def dequantize(t: QuantizedTensor, dtype=None) -> torch.Tensor:
    dtype = dtype or t.dtype
    q = _unpack(torch.as_tensor(t.q), t.bits)
    *lead, n = q.shape
    g = t.group_size
    qf = q.reshape(*lead, n // g, g).float()
    s = torch.as_tensor(t.scales).float()[..., None]
    b = torch.as_tensor(t.biases).float()[..., None]
    return (qf * s + b).reshape(*lead, n).to(dtype)


def qmm_kernel_route(t: QuantizedTensor, transpose: bool = True) -> bool:
    """Whether x @ dequant(t).T runs K5 (ops/qmatmul.py): the reference's
    rule (:256-260) for a 2-D 4- or 8-bit weight whose packed row holds whole
    groups, and a group size that K5 takes (`GROUP_SIZES`: 32, 64, 128;
    others take the dequantize route, ROADMAP Queue 3, divergences).  Its
    TPU check and its MLX_VLM_TPU_QMM switch are not ported."""
    from ..ops.qmatmul import GROUP_SIZES

    return (transpose and t.ndim == 2 and t.bits in (4, 8)
            and t.group_size in GROUP_SIZES
            and t.q.shape[1] % max(t.group_size, 2) == 0)


def quantized_matmul(x: torch.Tensor, t: QuantizedTensor,
                     transpose: bool = True) -> torch.Tensor:
    """x @ dequant(t).T (transpose=True, HF Linear layout) or x @ dequant(t).

    Weights that pass `qmm_kernel_route` go through K5; others are
    dequantized in x's dtype and multiplied, the reference's XLA route."""
    if qmm_kernel_route(t, transpose):
        from ..ops.qmatmul import quantized_matmul_kernel

        return quantized_matmul_kernel(x, t)
    w = dequantize(t, dtype=x.dtype)
    if transpose:  # x's free dims, then w's (the reference's dot_general)
        return torch.tensordot(x, w, dims=([x.dim() - 1], [w.dim() - 1]))
    return torch.matmul(x, w)


def from_mlx_packed(wq_u32: np.ndarray, scales, biases, bits: int,
                    group_size: int) -> QuantizedTensor:
    """Import an mlx affine-quantized checkpoint tensor.

    mlx packs little-endian along the input axis into uint32 words (8 x 4-bit
    or 4 x 8-bit per word); viewed as bytes this is the uint8 layout, with
    the low nibble first."""
    _check_bits(bits)
    return QuantizedTensor(
        q=np.asarray(wq_u32).view(np.uint8),
        scales=scales,
        biases=biases,
        bits=bits,
        group_size=group_size,
        out_dtype=dtype_name(scales),
    )


def _int4_half_width(N: int) -> int:
    """Padded half-width of the halves-packed layout: 128-aligned."""
    half = (N + 1) // 2
    return ((half + 127) // 128) * 128


def to_int4_grouped(t: QuantizedTensor) -> Int4GroupedTensor:
    """Bit-exact host repack of an mlx-affine 4-bit tensor [N, K]."""
    if t.bits != 4:
        raise ValueError("Int4GroupedTensor requires a 4-bit source")
    q = host_array(t.q)
    N, K2 = q.shape
    codes = np.empty((N, K2 * 2), np.uint8)
    codes[:, 0::2] = q & 0xF
    codes[:, 1::2] = q >> 4
    K = K2 * 2
    g = t.group_size
    G = K // g
    n2p = _int4_half_width(N)
    cp = np.zeros((K, 2 * n2p), np.uint8)
    cp[:, :N] = codes.T
    qp = (cp[:, :n2p] | (cp[:, n2p:] << 4)).astype(np.uint8)
    N_p = 2 * n2p
    s = np.zeros((N_p, G), np.float32)
    b = np.zeros((N_p, G), np.float32)
    s[:N] = host_array(t.scales, np.float32)
    b[:N] = host_array(t.biases, np.float32)
    s = s.T.reshape(G, 1, N_p)
    b = b.T.reshape(G, 1, N_p)
    return Int4GroupedTensor(
        qp=qp,
        sl=np.ascontiguousarray(s[..., :n2p]),
        sh=np.ascontiguousarray(s[..., n2p:]),
        bl=np.ascontiguousarray(b[..., :n2p]),
        bh=np.ascontiguousarray(b[..., n2p:]),
        n=N,
        group_size=g,
        out_dtype=t.out_dtype,
    )


def int4_grouped_dequantize(t: Int4GroupedTensor, dtype=None) -> torch.Tensor:
    """Dense [N, K] weight of a single (unstacked) Int4GroupedTensor."""
    dtype = dtype or t.dtype
    qp = torch.as_tensor(t.qp)
    K, n2p = qp.shape
    sl, sh, bl, bh = (torch.as_tensor(a) for a in (t.sl, t.sh, t.bl, t.bh))
    G = sl.shape[0]
    g = K // G
    qi = qp.to(torch.int32)
    lo = (qi & 0xF).float().reshape(G, g, n2p)
    hi = (qi >> 4).float().reshape(G, g, n2p)
    w = torch.cat([lo * sl + bl, hi * sh + bh], dim=-1)
    return w.reshape(K, 2 * n2p)[:, : t.n].T.to(dtype)
