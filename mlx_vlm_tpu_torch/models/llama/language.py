"""Llama-style decoder, shared by llama, mistral, qwen2 and qwen3 text
models and by LLaVA.

Port of mlx_vlm_tpu/models/llama/language.py (LanguageModel :22, __call__
:50, forward_captured :89, forward_masked :113, _mlp :151, _qkv :154,
_attention :169, _attention_nc :177, logits :185, embed :190, init_cache
:193).  Decoder
layers run as a Python loop over views of the stacked weights and the KV
cache is written in place, as in the Qwen-VL ports.  What a checkpoint
carries is picked up from its weights, as in the reference: q / k / v / o
biases (qwen2), per-head `q_norm` / `k_norm` (qwen3), a tied or separate
head.  `partial_rotary_factor` builds the rope at the rotated sub-dim
(apply_rope passes the tail through), and `residual_scale` and `_norm` are
the hooks later families override.  The reference has no fused decode step
for this decoder (`supports_fused_decode` False), so every step runs the
per-linear path (`step_logits`): K5 on each linear in the exact mode, K1 /
K2 under a forced w4grp, w8chan as plain tensor math, and the cache's
`attend` (K4 on the flash rule, K6-K8 with kv_bits).

`forward_captured` returns the final hidden state and every layer's output
[L, B, S, D] (the cache is written in place, so it is not returned).
`forward_masked` (:113, DDTree's tree verify) is a read-only forward of S
rows over the bf16 `KVCache` below its cursor and an [S, S] mask among the
rows, through `sdpa` as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core import cache as cache_lib
from ...core.layers import (embedding, embedding_as_linear, linear, rms_norm,
                            swiglu_mlp)
from ...core.mask import causal_cache_mask
from ...core.rope import apply_rope, make_rope
from ...ops.attention import sdpa
from ..base import layer_view
from .config import TextConfig


class LanguageModel:
    supports_fused_decode = False

    def __init__(self, args: TextConfig, config=None):
        self.args = args
        self.config = config or args
        self.n_heads = args.num_attention_heads
        self.n_kv_heads = args.num_key_value_heads
        self.head_dim = args.head_dim or args.hidden_size // self.n_heads
        self.scale = self.head_dim**-0.5
        # residual-branch multiplier (1.0 for llama; minicpm scales by
        # scale_depth / sqrt(num_layers))
        self.residual_scale = 1.0
        # block-norm hook: LayerNorm decoders override it
        self._norm = rms_norm
        rot = int(self.head_dim * getattr(args, "partial_rotary_factor", 1.0))
        self.rope = make_rope(rot, args.rope_theta, args.rope_scaling,
                              args.max_position_embeddings)
        self.fused_decode = False  # no fused step for this decoder

    def __call__(self, params: dict, inputs_embeds: torch.Tensor, cache,
                 position_ids: torch.Tensor,
                 causal: bool = True) -> torch.Tensor:
        """Forward over embeddings [B, S, D] -> final-normed hidden
        [B, S, D].  With a cache, each layer writes its k/v at
        `cache.offset` in place and the cursor advances by S; cache=None
        attends over the S tokens alone, causally or (`causal` False, the
        diffusion LMs' case) in full."""
        return self._forward(params, inputs_embeds, cache, position_ids,
                             causal, None)

    def forward_captured(self, params: dict, inputs_embeds: torch.Tensor,
                         cache, position_ids: torch.Tensor) -> tuple:
        """The cached forward, also returning every layer's output hidden
        states [L, B, S, D] (EAGLE-3-style drafters read some of them)."""
        hiddens: list = []
        h = self._forward(params, inputs_embeds, cache, position_ids, True,
                          hiddens)
        return h, torch.stack(hiddens)

    def forward_masked(self, params: dict, inputs_embeds: torch.Tensor,
                       cache, position_ids: torch.Tensor,
                       block_mask: torch.Tensor) -> torch.Tensor:
        """Read-only forward with a custom mask among the new rows
        (reference :113): the S rows attend to the cache below its cursor
        and to each other by `block_mask` (bool [S, S], True = attend);
        their K/V are used in flight and never written, and the cursor
        stays.  Returns the final-normed hidden [B, S, D].  It reads the
        raw buffers of a bf16 `KVCache` (exactly that class; any other
        cache raises)."""
        if type(cache) is not cache_lib.KVCache:
            raise TypeError(f"forward_masked reads a bf16 KVCache's buffers, "
                            f"not a {type(cache).__name__}")
        B, S, _ = inputs_embeds.shape
        cos, sin = self.rope.cos_sin(position_ids)
        mp = params["model"]
        eps = self.args.rms_norm_eps
        dev = inputs_embeds.device
        C = cache.capacity
        cache_part = (torch.arange(C, device=dev) < cache.offset)
        mask = torch.cat([cache_part[None, None, None, :].expand(B, 1, S, C),
                          block_mask.to(dev)[None, None].expand(B, 1, S, S)],
                         dim=-1)
        h = inputs_embeds
        for i in range(self.args.num_hidden_layers):
            lp = layer_view(mp["layers"], i)
            x = self._norm(lp["input_layernorm"], h, eps)
            q, k, v = self._qkv(lp["self_attn"], x)
            q, k = apply_rope(q, k, cos, sin)
            keys = torch.cat([cache.k[i], k.to(cache.k.dtype)], dim=2)
            vals = torch.cat([cache.v[i], v.to(cache.v.dtype)], dim=2)
            o = sdpa(q.contiguous(), keys, vals, self.scale, mask)
            o = o.transpose(1, 2).reshape(B, S, -1)
            h = self._residual(h, linear(lp["self_attn"]["o_proj"], o))
            x = self._norm(lp["post_attention_layernorm"], h, eps)
            h = self._residual(h, self._mlp(lp["mlp"], x))
        return self._norm(mp["norm"], h, eps)

    def _forward(self, params, inputs_embeds, cache, position_ids, causal,
                 hiddens) -> torch.Tensor:
        B, S, _ = inputs_embeds.shape
        cos, sin = self.rope.cos_sin(position_ids)  # [B, S, rot/2]
        mp = params["model"]
        eps = self.args.rms_norm_eps
        dev = inputs_embeds.device
        if cache is not None:
            mask = causal_cache_mask(cache.offset, cache.left_pad, S,
                                     cache.capacity)
        elif causal:
            mask = causal_cache_mask(0, torch.zeros((B,), dtype=torch.int32,
                                                    device=dev), S, S)
        else:
            mask = torch.ones((B, 1, S, S), dtype=torch.bool, device=dev)
        h = inputs_embeds
        for i in range(self.args.num_hidden_layers):
            lp = layer_view(mp["layers"], i)
            x = self._norm(lp["input_layernorm"], h, eps)
            h = self._residual(h, self._attention(lp["self_attn"], x, cos,
                                                  sin, mask, cache, i))
            x = self._norm(lp["post_attention_layernorm"], h, eps)
            h = self._residual(h, self._mlp(lp["mlp"], x))
            if hiddens is not None:
                hiddens.append(h)
        if cache is not None:
            cache.advance(S)
        return self._norm(mp["norm"], h, eps)

    def _residual(self, h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.residual_scale == 1.0:
            return h + y
        return h + self.residual_scale * y

    def _mlp(self, p, x):
        return swiglu_mlp(p, x)

    def _qkv(self, p, x):
        B, S, _ = x.shape
        q = linear(p["q_proj"], x).reshape(B, S, self.n_heads, self.head_dim)
        k = linear(p["k_proj"], x).reshape(B, S, self.n_kv_heads,
                                           self.head_dim)
        v = linear(p["v_proj"], x).reshape(B, S, self.n_kv_heads,
                                           self.head_dim)
        # qwen3-style per-head-dim q/k norms when the checkpoint carries them
        if "q_norm" in p:
            q = rms_norm(p["q_norm"], q, self.args.rms_norm_eps)
        if "k_norm" in p:
            k = rms_norm(p["k_norm"], k, self.args.rms_norm_eps)
        return tuple(a.transpose(1, 2) for a in (q, k, v))

    def _attention(self, p, x, cos, sin, mask, cache, layer):
        B, S, _ = x.shape
        q, k, v = self._qkv(p, x)
        q, k = apply_rope(q, k, cos, sin)
        q = q.contiguous()
        if cache is None:
            out = sdpa(q, k, v, self.scale, mask)
        else:
            out = cache.attend(layer, q, k, v, self.scale, mask)
        out = out.transpose(1, 2).reshape(B, S, -1)
        return linear(p["o_proj"], out)

    def step_logits(self, params: dict, inputs_embeds: torch.Tensor, cache,
                    position_ids: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V] of a forward step (the per-linear path)."""
        return self.logits(params, self(params, inputs_embeds, cache,
                                        position_ids))

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        if self.args.tie_word_embeddings:
            return embedding_as_linear(params["model"]["embed_tokens"], hidden)
        return linear(params["lm_head"], hidden)

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        return embedding(params["model"]["embed_tokens"], input_ids)

    def init_cache(self, batch_size: int, capacity: int, dtype=torch.bfloat16,
                   left_pad=None, device=None) -> cache_lib.KVCache:
        return cache_lib.init_cache(
            self.args.num_hidden_layers, batch_size, self.n_kv_heads,
            self.head_dim, capacity, dtype, left_pad, device)
