"""Shared decoder of the classic GPT-era text families.

Port of mlx_vlm_tpu/models/classic_base.py (ClassicConfig :30,
_per_head_layer_norm :73, ClassicLanguageModel :82, ClassicModel :197):
one decoder set by config flags (the norm: LayerNorm, nemotron's
LayerNorm1P or RMSNorm; the MLP: gelu, gelu-tanh, relu^2 or SwiGLU;
learned absolute positions `wpe` or a partial rotary; a sequential, a
parallel or a parallel shared-LayerNorm residual; per-head q / k
LayerNorms), over the canonical keys that each family's `sanitize` writes:
model.{wte, wpe?, ln_f}, model.layers.{i}.{ln1, ln2?, attn.{q,k,v,o}_proj,
attn.{q,k}_norms?, mlp.*}.  The layers run as a Python loop over views of
the stacked weights, the port's idiom (the reference's `quant_scan` is not
ported).

Each layer writes its k / v into the cache's bf16 buffers with
`update_layer` and attends through `sdpa`, as the reference does
(:168-171): no flash kernel and no quantized cache (any cache but a
`KVCache` raises).  The embedding table goes through `embedding` and the
tied head through `embedding_as_linear`, so an mlx-quantized table is
gathered, then dequantized (w8chan, or K5's codes in the exact mode),
where the reference gathers the raw table and multiplies by it (ROADMAP
Queue 3, known faults).  The linears take the runtime mode's route: K5
in the exact mode, per-channel int8 by default for a 4-bit checkpoint (no
family here has a fused decode step).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import cache as cache_lib
from ..core.layers import (embedding, embedding_as_linear, layer_norm, linear,
                           rms_norm)
from ..core.mask import causal_cache_mask
from ..core.rope import Rope, apply_rope, default_inv_freq
from ..ops.attention import sdpa
from .base import contiguous, layer_view
from .llama.llama import Model as _LlamaModel

STACK_PATTERNS = ("language_model.model.layers",)


@dataclasses.dataclass
class ClassicConfig:
    model_type: str = "gpt2"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    intermediate_size: Optional[int] = None
    vocab_size: int = 50257
    layer_norm_eps: float = 1e-5
    max_position_embeddings: int = 2048
    tie_word_embeddings: bool = True
    # positional scheme
    rope_pct: float = 0.0  # 0 => learned absolute positions (wpe)
    rope_theta: float = 10000.0
    rope_scale: float = 1.0
    # topology / flavour
    norm: str = "layer"  # layer | layer1p | rms
    parallel: bool = False  # x + attn(ln1 x) + mlp(ln x) vs sequential
    parallel_shared_ln: bool = False  # parallel branches share ln1
    act: str = "gelu"  # gelu | gelu_tanh | relu2 | swiglu
    qk_headnorm: bool = False  # per-head LayerNorm stacks on q/k

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @classmethod
    def from_dict(cls, d: dict) -> "ClassicConfig":
        sig = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in d.items() if k in sig})


def _per_head_layer_norm(w: torch.Tensor, x: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """x [B, S, H, hd] normalized per head, then scaled by w [H, hd]."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return (xn * w.float()[None, None]).to(x.dtype)


class ClassicLanguageModel:
    supports_fused_decode = False

    def __init__(self, args: ClassicConfig, config=None):
        self.args = args
        self.config = config or args
        self.n_heads = args.num_attention_heads
        self.n_kv_heads = args.num_key_value_heads
        self.head_dim = args.head_dim
        self.scale = args.head_dim**-0.5
        self.rope_dim = int(args.head_dim * args.rope_pct)
        self.rope = None
        if self.rope_dim:
            # the reference's f32 product of the f32 frequencies and scale
            self.rope = Rope(self.rope_dim, args.rope_theta)
            self.rope.inv_freq = (
                default_inv_freq(self.rope_dim, args.rope_theta).astype(
                    np.float32) * np.float32(args.rope_scale))
        self.fused_decode = False  # no fused step for these decoders

    def _norm(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        a = self.args
        if a.norm == "rms":
            return rms_norm(p, x, a.layer_norm_eps)
        if a.norm == "layer1p":
            # nemotron's LayerNorm1P: weight + 1, in the weight's dtype
            p = dict(p, weight=p["weight"] + 1.0)
        return layer_norm(p, x, a.layer_norm_eps)

    def _mlp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        a = self.args
        if a.act == "swiglu":
            g = linear(p["gate_proj"], x)
            u = linear(p["up_proj"], x)
            return linear(p["down_proj"], F.silu(g) * u)
        if a.act == "relu2":
            h = torch.square(F.relu(linear(p["up_proj"], x)))
            return linear(p["down_proj"], h)
        h = linear(p["fc1"], x)
        h = F.gelu(h, approximate="tanh" if a.act == "gelu_tanh" else "none")
        return linear(p["fc2"], h)

    def init_cache(self, batch_size: int, capacity: int, dtype=torch.bfloat16,
                   left_pad=None, device=None) -> cache_lib.KVCache:
        return cache_lib.init_cache(
            self.args.num_hidden_layers, batch_size, self.n_kv_heads,
            self.head_dim, capacity, dtype, left_pad, device)

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        return embedding(params["model"]["wte"], input_ids)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        if self.args.tie_word_embeddings or "lm_head" not in params:
            return embedding_as_linear(params["model"]["wte"], hidden)
        return linear(params["lm_head"], hidden)

    def step_logits(self, params: dict, inputs_embeds: torch.Tensor, cache,
                    position_ids: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V] of a forward step."""
        return self.logits(params, self(params, inputs_embeds, cache,
                                        position_ids))

    def __call__(self, params: dict, inputs_embeds: torch.Tensor, cache,
                 position_ids: torch.Tensor) -> torch.Tensor:
        """Forward over embeddings [B, S, D] -> final-normed hidden
        [B, S, D]; with a cache each layer writes its k / v at the cursor
        in place and the cursor advances by S, without one the S rows
        attend causally among themselves."""
        a = self.args
        B, S, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        pos = position_ids[0] if position_ids.dim() == 3 else position_ids
        mp = params["model"]
        h = inputs_embeds
        if "wpe" in mp:
            h = h + embedding(mp["wpe"], pos.long()).to(h.dtype)
        cos = sin = None
        if self.rope is not None:
            cos, sin = self.rope.cos_sin(pos)
        if cache is None:
            mask = causal_cache_mask(0, torch.zeros((B,), dtype=torch.int32,
                                                    device=dev), S, S)
        elif not isinstance(cache, cache_lib.KVCache):
            raise TypeError(f"the classic decoders write a bf16 KVCache, not "
                            f"a {type(cache).__name__}")
        else:
            mask = causal_cache_mask(cache.offset, cache.left_pad, S,
                                     cache.capacity)
        for i in range(a.num_hidden_layers):
            lp = layer_view(mp["layers"], i)
            if a.parallel:
                x1 = self._norm(lp["ln1"], h)
                x2 = x1 if a.parallel_shared_ln else self._norm(lp["ln2"], h)
                h = h + self._attention(lp["attn"], x1, cos, sin, mask,
                                        cache, i) + self._mlp(lp["mlp"], x2)
            else:
                x = self._norm(lp["ln1"], h)
                h = h + self._attention(lp["attn"], x, cos, sin, mask, cache,
                                        i)
                x = self._norm(lp["ln2"], h)
                h = h + self._mlp(lp["mlp"], x)
        if cache is not None:
            cache.advance(S)
        return self._norm(mp["ln_f"], h)

    def _attention(self, ap: dict, x, cos, sin, mask, cache, layer: int):
        a = self.args
        B, S, _ = x.shape
        hd = self.head_dim
        q = linear(ap["q_proj"], x).reshape(B, S, self.n_heads, hd)
        k = linear(ap["k_proj"], x).reshape(B, S, self.n_kv_heads, hd)
        v = linear(ap["v_proj"], x).reshape(B, S, self.n_kv_heads, hd)
        if a.qk_headnorm:
            q = _per_head_layer_norm(ap["q_norms"]["weight"], q,
                                     a.layer_norm_eps)
            k = _per_head_layer_norm(ap["k_norms"]["weight"], k,
                                     a.layer_norm_eps)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if cos is not None:
            q, k = apply_rope(q, k, cos, sin)  # the first rope_dim lanes
        q = q.contiguous()
        if cache is not None:
            k, v = cache_lib.update_layer(cache.k[layer], cache.v[layer], k,
                                          v, cache.offset)
        o = sdpa(q, k, v, self.scale, mask)
        o = o.transpose(1, 2).reshape(B, S, -1)
        return linear(ap["o_proj"], o)


class ClassicModel(_LlamaModel):
    """The llama model's interface over the classic decoder; each family
    sets its ModelConfig and `sanitize`."""

    language_model_class = ClassicLanguageModel

    def sanitize(self, weights: dict) -> dict:
        raise NotImplementedError

    @property
    def stack_patterns(self):
        return STACK_PATTERNS


# ---- checkpoint helpers of the families' `sanitize`: arrays are numpy
# (float weights, or the uint32 codes of an mlx-quantized weight) or torch
# tensors (bf16 weights, scales and biases); a quantized weight's `.scales`
# and `.biases` [out, in / group] split by rows as its codes and bias do

def stack(vals: list):
    if isinstance(vals[0], torch.Tensor):
        return torch.stack(vals)
    return np.stack([np.asarray(v) for v in vals])


def is_codes(v) -> bool:
    """Whether v holds an mlx-quantized weight's packed uint32 codes."""
    return isinstance(v, np.ndarray) and v.dtype == np.uint32


def split_rows(v, sizes) -> list:
    """v's leading axis cut into consecutive slices of `sizes` rows."""
    out, at = [], 0
    for n in sizes:
        out.append(contiguous(v[at:at + n]))
        at += n
    return out


# the last part of a checkpoint key: a weight and its bias, or the scales
# and biases of an mlx-quantized weight
PARAM_RE = "(weight|bias|scales|biases)"
