"""Functional neural-net building blocks over parameter dicts.

Port of mlx_vlm_tpu/core/layers.py.  Parameters are nested dicts whose keys
mirror the HF safetensors names; each layer takes its parameter subtree as
the first argument.  Norms and softmax accumulate in f32; matmuls run in the
input dtype with f32 accumulation.

`linear` takes the adapters that trainer/lora.py attaches beside a weight
(reference :69-100): LoRA factors (`lora_a` [r, in], `lora_b` [out, r],
the scale folded into `lora_b`) add (x A^T) B^T to the base product, which
keeps its own route (K1 / K2 / K5 or w8chan); the two rank-r products are
plain matmuls, as the reference computes them outside Pallas.  DoRA (a
`dora_m` [out] magnitude beside the factors) dequantizes the base, adds
B A in f32 and scales each output row by m / ||W + B A||, a dense product
as in the reference.  Stacked factors [L, r, in] slice with the layer
(`models/base.py` `layer_view`).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from .quant import (ChannelQuantizedTensor, Int4GroupedTensor, QuantizedTensor,
                    channel_quantized_matmul, dequantize, quantized_matmul)

__all__ = [
    "linear",
    "embedding",
    "embedding_as_linear",
    "rms_norm",
    "layer_norm",
    "swiglu_mlp",
    "gelu_mlp",
]


def _matmul_wT(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.T for a dense or quantized weight in HF [out, in] layout:
    grouped int4 (w4grp) through K1 / K2, mlx group-affine (exact) through
    `quantized_matmul` (K5), per-channel int8 (w8chan) as plain tensor
    math."""
    if isinstance(w, Int4GroupedTensor):
        from ..ops.int4_matvec import int4_matvec

        return int4_matvec(x, w)
    if isinstance(w, QuantizedTensor):
        return quantized_matmul(x, w, transpose=True)
    if isinstance(w, ChannelQuantizedTensor):
        if os.environ.get("MLX_VLM_TPU_ACT_QUANT", "0") in ("1", "true"):
            raise NotImplementedError(
                "MLX_VLM_TPU_ACT_QUANT (int8 activations) is not ported")
        return channel_quantized_matmul(x, w)
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(f"weight type {type(w).__name__}")
    return torch.matmul(x, w.to(x.dtype).transpose(-1, -2))


def dense_weight(w) -> torch.Tensor:
    """A linear's weight [.., out, in] as a dense tensor: quantized layouts
    dequantized in their own dtype, a dense one as it is."""
    if isinstance(w, QuantizedTensor):
        return dequantize(w)
    if isinstance(w, ChannelQuantizedTensor):
        dt = w.dtype
        return (w.q8.to(dt) * w.scales.to(dt)
                + w.biases.to(dt)).transpose(-1, -2)
    if isinstance(w, Int4GroupedTensor):
        from .quant import int4_grouped_dequantize

        if w.qp.dim() != 2:
            raise NotImplementedError("a stacked w4grp weight under DoRA")
        return int4_grouped_dequantize(w)
    return w


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """HF Linear: y = x @ W.T + b.  p = {"weight": [out, in], "bias"?: [out]}
    and, when an adapter is attached, LoRA's `lora_a` / `lora_b` or DoRA's
    with `dora_m` (module docstring)."""
    if "dora_m" in p:
        delta = torch.einsum("...or,...ri->...oi", p["lora_b"].float(),
                             p["lora_a"].float())
        adapted = dense_weight(p["weight"]).float() + delta
        norm = torch.sqrt(adapted.square().sum(dim=-1) + 1e-12)
        y = _matmul_wT(x, adapted) * (p["dora_m"].float() / norm).to(x.dtype)
    else:
        y = _matmul_wT(x, p["weight"])
    b = p.get("bias")
    if b is not None:
        y = y + b.to(y.dtype)
    if "lora_a" in p and "dora_m" not in p:
        z = _matmul_wT(x, p["lora_a"])  # [..., r]
        y = y + _matmul_wT(z, p["lora_b"])
    return y


def embedding(p: dict, ids: torch.Tensor) -> torch.Tensor:
    """p = {"weight": [vocab, dim]} -> [..., dim]."""
    w = p["weight"]
    if isinstance(w, ChannelQuantizedTensor):
        # channel layout is [dim, vocab]: gather columns, dequant the slice
        dt = w.dtype
        q = w.q8[:, ids]  # [dim, ...ids]
        s = w.scales[:, ids]
        b = w.biases[:, ids]
        out = q.to(dt) * s.to(dt) + b.to(dt)
        return torch.movedim(out, 0, -1)
    if isinstance(w, QuantizedTensor):
        # gather the rows, then dequantize only them: the reference's values
        # (it dequantizes the whole table first) without a dense table copy
        rows = QuantizedTensor(q=w.q[ids], scales=w.scales[ids],
                               biases=w.biases[ids], bits=w.bits,
                               group_size=w.group_size, out_dtype=w.out_dtype)
        return dequantize(rows)
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(f"{type(w).__name__} embedding tables")
    return w[ids]


def embedding_as_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding head: logits = x @ E.T."""
    return _matmul_wT(x, p["weight"])


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6, *,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with f32 accumulation; `offset=1.0` gives Gemma's (1 + w)
    convention (the weight stored as w - 1), added in f32."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    return (xn * (p["weight"].float() + offset)).to(dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    if "weight" in p:
        xn = xn * p["weight"].float()
    if p.get("bias") is not None:
        xn = xn + p["bias"].float()
    return xn.to(dtype)


def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(x)) * up(x))."""
    g = linear(p["gate_proj"], x)
    u = linear(p["up_proj"], x)
    return linear(p["down_proj"], F.silu(g) * u)


def gelu_mlp(p: dict, x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """fc2(gelu(fc1(x))), ViT-style."""
    h = linear(p["fc1"], x)
    h = F.gelu(h, approximate="tanh" if approximate else "none")
    return linear(p["fc2"], h)
