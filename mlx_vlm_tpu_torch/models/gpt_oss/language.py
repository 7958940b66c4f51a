"""GPT-OSS decoder: attention sinks, alternating sliding / full layers and
a clipped-SwiGLU mixture of experts with expert biases.

Port of mlx_vlm_tpu/models/gpt_oss/language.py (clipped_swiglu :38,
LanguageModel :48, __call__ :68, _qkv :124, _moe :131, logits :150) on the
llama decoder of the port (its q / k / v / o linears with their biases,
its rope, cache and head).  Each layer reads one of two masks made once a
call, the full causal mask or the one of the last `sliding_window` rows,
by its entry of `layer_types` (a host list, so the choice is fixed per
layer and a decode step still captures as one CUDA graph); its sinks, one
f32 logit per head stacked [L, n_heads], join the softmax as one column
(ops/attention.py `softmax_with_sinks`) through `sdpa` or the cache's
`attend`, which keeps every attention kernel off (K4 is refused as in the
reference, `flash_ok=False`, :102-106; K6-K8 by the sinks).  The router
takes the top k of its biased f32 logits, then a softmax over those k
(:131-147), and feeds `core/moe.py`'s `switch_glu` with the clipped
SwiGLU and the expert biases: on the card K5's expert-indexed GEMV at
decode, K5 per expert in long prefill chunks.

The rope is YaRN with gpt-oss's `truncate: false` honoured (core/rope.py),
where the reference rounds the correction range (ROADMAP Queue 3).
`forward_captured` and `forward_masked` (the speculative drafters' hooks)
are not offered: no drafter targets this decoder.
"""

from __future__ import annotations

import torch

from ...core.layers import linear, rms_norm
from ...core.mask import causal_cache_mask
from ...core.moe import switch_glu
from ...core.rope import apply_rope
from ...ops.attention import sdpa
from ..base import layer_view
from ..llama.language import LanguageModel as _LlamaLanguage
from .config import TextConfig

ALPHA = 1.702
LIMIT = 7.0


def clipped_swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(up + 1) * gate * sigmoid(alpha * gate), the gate clipped above at
    LIMIT and the up branch to [-LIMIT, LIMIT]; the sigmoid in f32."""
    g = torch.clamp(g, max=LIMIT)
    u = torch.clamp(u, -LIMIT, LIMIT)
    glu = g * torch.sigmoid(ALPHA * g.float()).to(g.dtype)
    return (u + 1.0) * glu


def layer_types(args: TextConfig) -> list:
    """Each layer's "sliding_attention" or "full_attention": the config's
    list, else sliding / full alternating from a sliding first layer."""
    return list(args.layer_types or (
        ["sliding_attention", "full_attention"]
        * (args.num_hidden_layers // 2 + 1))[: args.num_hidden_layers])


class LanguageModel(_LlamaLanguage):
    def __init__(self, args: TextConfig, config=None):
        super().__init__(args, config)
        self.top_k = args.num_experts_per_tok
        self.is_full = [t == "full_attention" for t in layer_types(args)]

    def forward_captured(self, *a, **k):
        raise NotImplementedError("gpt_oss has no drafter hooks")

    forward_masked = forward_captured

    def masks(self, cache, B: int, S: int, device) -> tuple:
        """(full mask, sliding mask), bool [B, 1, S, C] (C = S without a
        cache)."""
        if cache is None:
            off, lp, cap = 0, torch.zeros((B,), dtype=torch.int32,
                                          device=device), S
        else:
            off, lp, cap = cache.offset, cache.left_pad, cache.capacity
        return (causal_cache_mask(off, lp, S, cap),
                causal_cache_mask(off, lp, S, cap,
                                  window=self.args.sliding_window))

    def _forward(self, params, inputs_embeds, cache, position_ids, causal,
                 hiddens) -> torch.Tensor:
        if not causal:
            raise NotImplementedError("gpt_oss attends causally only")
        B, S, _ = inputs_embeds.shape
        cos, sin = self.rope.cos_sin(position_ids)
        mp = params["model"]
        eps = self.args.rms_norm_eps
        full, sliding = self.masks(cache, B, S, inputs_embeds.device)
        h = inputs_embeds
        for i in range(self.args.num_hidden_layers):
            lp = layer_view(mp["layers"], i)
            mask = full if self.is_full[i] else sliding
            x = rms_norm(lp["input_layernorm"], h, eps)
            h = h + self._attention(lp["self_attn"], x, cos, sin, mask,
                                    cache, i)
            x = rms_norm(lp["post_attention_layernorm"], h, eps)
            h = h + self._mlp(lp["mlp"], x)
        if cache is not None:
            cache.advance(S)
        return rms_norm(mp["norm"], h, eps)

    def _attention(self, p, x, cos, sin, mask, cache, layer):
        B, S, _ = x.shape
        q, k, v = self._qkv(p, x)
        q, k = apply_rope(q, k, cos, sin)
        q = q.contiguous()
        if cache is None:
            out = sdpa(q, k, v, self.scale, mask, sinks=p["sinks"])
        else:
            out = cache.attend(layer, q, k, v, self.scale, mask,
                               flash_ok=False, sinks=p["sinks"])
        out = out.transpose(1, 2).reshape(B, S, -1)
        return linear(p["o_proj"], out)

    def _mlp(self, p, x):
        B, S, D = x.shape
        flat = x.reshape(B * S, D)
        logits = linear(p["router"], flat).float()
        vals, indices = torch.topk(logits, self.top_k, dim=-1)
        weights = torch.softmax(vals, dim=-1)
        ex = p["experts"]
        out = switch_glu(
            flat, ex["gate_proj"]["weight"], ex["up_proj"]["weight"],
            ex["down_proj"]["weight"], indices, weights, act2=clipped_swiglu,
            biases=(ex["gate_proj"]["bias"], ex["up_proj"]["bias"],
                    ex["down_proj"]["bias"]))
        return out.reshape(B, S, D)
