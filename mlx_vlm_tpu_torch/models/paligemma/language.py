"""Gemma-1 / Gemma-2 decoder (PaliGemma's language model, and text-only
gemma / gemma2 checkpoints).

Port of mlx_vlm_tpu/models/paligemma/language.py (LanguageModel :32,
_masks :57, __call__ :74, _mlp :126, _qkv :131, logits :136, embed :143,
init_cache :146).  Decoder layers run as a Python loop over views of the
stacked weights and the KV cache is written in place, as in the llama
decoder.  Gemma's pieces: the embeddings times sqrt(hidden), the scalar
rounded to the activations' dtype first, as the reference does; (1 + w)
RMSNorms (`rms_norm(offset=1.0)`); tanh-GELU gate; gemma2's sandwich norms
around attention and MLP, its `query_pre_attn_scalar` as the score scale,
its attention soft-cap (on the f32 scores, before the mask) and its final
soft-cap (tanh in the logits' dtype); and per layer the full mask or,
on gemma2's sliding layers, the window's.

The prefix: with `use_bidirectional_attention` (PaliGemma's default) a
chunk of S > 1 rows attends without a causal order to every row written
so far (`full_valid_mask`, the window ignored within the prefix, as in the
reference), and a decode step (S == 1) takes the causal mask.  The
prefill pads its last chunk (generate/ar.py, generate/batch.py), and the
reference's mask lets the prompt's rows see that padding, so that its
logits move with the chunk size (ROADMAP, known faults in the
reference).  Here the prefill records on the cache where the prompt ends
(`cache.prompt_end`, core/cache.py `set_prompt_end`: an int, or int [B]
for a batch of right-padded rows), and the prefix mask stops there:
min(cursor + S, prompt_end).  Every chunk of a long prompt still sees only
the rows written so far, as in the reference.

Both masks of a step are built once from the device cursor and each layer
takes one by its Python layer type, so that a decode step captures.
Every `attend` passes `flash_ok=False`, as the reference does: K4 is
causal and never takes the prefix; and gemma2's soft-cap keeps K6-K8 off.
There is no fused decode step: a 4-bit checkpoint loads w8chan by default,
and `MLX_VLM_TPU_RUNTIME_QUANT=exact` puts every linear and the tied head
on K5.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core import cache as cache_lib
from ...core.layers import embedding, embedding_as_linear, linear, rms_norm
from ...core.mask import causal_cache_mask, full_valid_mask
from ...core.rope import apply_rope, make_rope
from ...ops.attention import sdpa
from ..base import layer_view
from .config import TextConfig


def scalar_in(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` (the reference casts its scalars to the
    activations' dtype before it multiplies or divides by them)."""
    return float(torch.tensor(value, dtype=dtype))


class LanguageModel:
    supports_fused_decode = False

    def __init__(self, args: TextConfig, config=None):
        if args.model_type not in ("gemma", "gemma2"):
            raise ValueError(
                f"PaliGemma text model {args.model_type!r} unsupported")
        self.args = args
        self.config = config or args
        self.is_gemma2 = args.model_type == "gemma2"
        self.n_heads = args.num_attention_heads
        self.n_kv_heads = args.num_key_value_heads
        self.head_dim = args.head_dim
        if self.is_gemma2 and args.query_pre_attn_scalar:
            self.scale = args.query_pre_attn_scalar**-0.5
        else:
            self.scale = self.head_dim**-0.5
        self.rope = make_rope(self.head_dim, args.rope_theta)
        layer_types = (args.layer_types
                       or ["full_attention"] * args.num_hidden_layers)
        self.is_full = [t == "full_attention" for t in layer_types]
        self.any_sliding = not all(self.is_full)
        self.bidirectional = bool(args.use_bidirectional_attention)
        self.softcap = args.attn_logit_softcapping if self.is_gemma2 else None
        self.fused_decode = False  # no fused step for this decoder

    def masks(self, cache, B: int, S: int, device) -> tuple:
        """(full-attention mask, sliding mask) of a call, bool
        [B, 1, S, C]: the bidirectional prefix for a chunk of S > 1 rows
        (stopping at the cache's `prompt_end` where the prefill recorded
        one), else the causal mask and its window."""
        end = None
        if cache is None:
            off, lp, cap = 0, torch.zeros((B,), dtype=torch.int32,
                                          device=device), S
        else:
            off, lp, cap = cache.offset, cache.left_pad, cache.capacity
            end = getattr(cache, "prompt_end", None)
        if self.bidirectional and S > 1:
            total = off + S
            if end is not None:
                total = torch.minimum(torch.as_tensor(total, device=device),
                                      end)
            m = full_valid_mask(lp, total, cap)[:, None, None, :]
            m = m.expand(B, 1, S, cap)
            return m, m  # the window is ignored within the prefix
        full = causal_cache_mask(off, lp, S, cap)
        if not self.any_sliding:
            return full, full
        return full, causal_cache_mask(off, lp, S, cap,
                                       window=self.args.sliding_window)

    def __call__(self, params: dict, inputs_embeds: torch.Tensor, cache,
                 position_ids: torch.Tensor) -> torch.Tensor:
        """Forward over embeddings [B, S, D] -> final-normed hidden
        [B, S, D].  With a cache, each layer writes its k/v at
        `cache.offset` in place and the cursor advances by S; cache=None
        attends over the S rows alone."""
        args = self.args
        B, S, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        cos, sin = self.rope.cos_sin(position_ids)
        h = inputs_embeds * scalar_in(args.hidden_size**0.5,
                                      inputs_embeds.dtype)
        mp = params["model"]
        eps = args.rms_norm_eps
        full, sliding = self.masks(cache, B, S, dev)
        for i in range(args.num_hidden_layers):
            lp = layer_view(mp["layers"], i)
            mask = full if self.is_full[i] else sliding
            x = rms_norm(lp["input_layernorm"], h, eps, offset=1.0)
            attn = self._attention(lp["self_attn"], x, cos, sin, mask, cache,
                                   i)
            if self.is_gemma2:  # sandwich norms
                h = h + rms_norm(lp["post_attention_layernorm"], attn, eps,
                                 offset=1.0)
                x = rms_norm(lp["pre_feedforward_layernorm"], h, eps,
                             offset=1.0)
                h = h + rms_norm(lp["post_feedforward_layernorm"],
                                 self._mlp(lp["mlp"], x), eps, offset=1.0)
            else:
                h = h + attn
                x = rms_norm(lp["post_attention_layernorm"], h, eps,
                             offset=1.0)
                h = h + self._mlp(lp["mlp"], x)
        if cache is not None:
            cache.advance(S)
        return rms_norm(mp["norm"], h, eps, offset=1.0)

    def _mlp(self, p, x):
        g = linear(p["gate_proj"], x)
        u = linear(p["up_proj"], x)
        return linear(p["down_proj"], F.gelu(g, approximate="tanh") * u)

    def _qkv(self, p, x):
        B, S, _ = x.shape
        q = linear(p["q_proj"], x).reshape(B, S, self.n_heads, self.head_dim)
        k = linear(p["k_proj"], x).reshape(B, S, self.n_kv_heads,
                                           self.head_dim)
        v = linear(p["v_proj"], x).reshape(B, S, self.n_kv_heads,
                                           self.head_dim)
        return tuple(a.transpose(1, 2) for a in (q, k, v))

    def _attention(self, p, x, cos, sin, mask, cache, layer):
        B, S, _ = x.shape
        q, k, v = self._qkv(p, x)
        q, k = apply_rope(q, k, cos, sin)
        q = q.contiguous()
        if cache is None:
            out = sdpa(q, k, v, self.scale, mask, self.softcap)
        else:
            out = cache.attend(layer, q, k, v, self.scale, mask,
                               flash_ok=False, logit_softcap=self.softcap)
        out = out.transpose(1, 2).reshape(B, S, -1)
        return linear(p["o_proj"], out)

    def step_logits(self, params: dict, inputs_embeds: torch.Tensor, cache,
                    position_ids: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V] of a forward step (the per-linear path)."""
        return self.logits(params, self(params, inputs_embeds, cache,
                                        position_ids))

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """The tied head, then gemma2's final soft-cap in the logits'
        dtype."""
        out = embedding_as_linear(params["model"]["embed_tokens"], hidden)
        cap = self.args.final_logit_softcapping
        if self.is_gemma2 and cap:
            out = torch.tanh(out / cap) * cap
        return out

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        return embedding(params["model"]["embed_tokens"], input_ids)

    def init_cache(self, batch_size: int, capacity: int, dtype=torch.bfloat16,
                   left_pad: Optional[torch.Tensor] = None,
                   device=None) -> cache_lib.KVCache:
        return cache_lib.init_cache(
            self.args.num_hidden_layers, batch_size, self.n_kv_heads,
            self.head_dim, capacity, dtype, left_pad, device)
