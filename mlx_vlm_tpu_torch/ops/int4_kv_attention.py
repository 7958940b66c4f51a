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
KV head at 4 bits).  The kernel splits the history over blocks of 128
tokens, each serving every query row of its KV head, and combines their
(max, sum, acc, bias) partials in a second pass.  See the .cu header.

On CPU tensors the wrapper computes the plain PyTorch version
`int4_kv_decode_attention_plain`; on CUDA tensors it launches the kernel or
raises.  `launches` counts calls that launched the kernel.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import _cuda

launches = {"int4_kv_attention": 0}

TC = 128  # history tokens per block (csrc/int4_kv_attention.cu)


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
    """An int or [BH] cursor -> int32 [BH] on `device`."""
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
    if D % 2 or k4.shape != (BH, C, D // 2) or v4.shape != k4.shape:
        raise ValueError(f"int4_kv_decode_attention: unsupported shapes "
                         f"q8 {tuple(q8.shape)} k4 {tuple(k4.shape)}")
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
    n_split = (C + TC - 1) // TC
    f32 = dict(dtype=torch.float32, device=q8.device)
    part_ml = torch.empty((n_split, BH, g, 3), **f32)  # m, l, bias
    part_acc = torch.empty((n_split, BH, g, D), **f32)
    out = torch.empty((BH, g, D), **f32)
    err = _cuda.library().mvt_int4_kv_attention(
        q8.data_ptr(), qsum_qs.data_ptr(), k4.data_ptr(), ks.data_ptr(),
        kb.data_ptr(), v4.data_ptr(), vs.data_ptr(), vb.data_ptr(),
        off.data_ptr(), lp.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), BH, g, C, D, float(scale),
        _cuda.stream_handle(q8.device))
    _cuda.check(err, "int4_kv_decode_attention")
    launches["int4_kv_attention"] += 1
    return out
