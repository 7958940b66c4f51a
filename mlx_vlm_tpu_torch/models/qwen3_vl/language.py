"""Qwen3-VL language model: the Qwen3 decoder (q / k RMSNorms over the head
dimension) with interleaved M-RoPE and deepstack visual injection.

Port of mlx_vlm_tpu/models/qwen3_vl/language.py (LanguageModel :38,
__call__ :52-132, _mlp :127, _qkv :137, logits :147, init_cache :155,
get_rope_index :162).  Deepstack features arrive channel-packed in the
embeddings, [B, S, D * (1 + n_ds)]: decoder layer i < n_ds adds slice i
to its output (the reference's :220-229 in the upstream model), so that
prefill chunking, which slices positions, keeps them aligned and every
entry point passes one array.  Decode steps pass plain [B, 1, D].  With
fewer decoder layers than deepstack levels, the levels past the last layer
are not added (the upstream model's rule; the JAX package's scan refuses
such a model).  Decoder layers run as a Python loop over views of the
stacked weights and the KV cache is written in place, as in Qwen2-VL's
port.  `step_logits` has the Qwen2-VL language model's contract; the
reference has no fused decode step for this family, so every step runs the
per-linear path (`fused_decode` stays False).  `get_rope_index` splits
each video's grid [t, h, w] into t grids [1, h, w], one a frame group,
as transformers' modeling_qwen3_vl.py:916-930 does for the timestamped
prompt (each frame group its own span between a time and a vision start /
end pair); the reference keeps Qwen2-VL's rule (:155-167), whose one span
of t * h * w / merge^2 tokens runs past the first frame group's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core import cache as cache_lib
from ...core.layers import (embedding, embedding_as_linear, linear, rms_norm,
                            swiglu_mlp)
from ...core.mask import causal_cache_mask
from ...core.rope import apply_rope, make_rope
from ...ops.attention import sdpa
from ..base import layer_view
from ..qwen2_vl.language import Cache, mrope_position_ids
from .config import ModelConfig, TextConfig

STACK_PREFIX = "model.layers"


class LanguageModel:
    supports_fused_decode = False

    def __init__(self, args: TextConfig, config: Optional[ModelConfig] = None):
        self.args = args
        self.config = config
        self.n_heads = args.num_attention_heads
        self.n_kv_heads = args.num_key_value_heads
        self.head_dim = args.head_dim
        self.scale = self.head_dim**-0.5
        self.rope = make_rope(self.head_dim, args.rope_theta, args.rope_scaling,
                              mrope_style="interleaved")
        self.fused_decode = False  # no fused step for this family

    def __call__(self, params: dict, inputs_embeds: torch.Tensor,
                 cache: Optional[Cache],
                 position_ids: torch.Tensor) -> torch.Tensor:
        """Forward over embeddings [B, S, D] or channel-packed
        [B, S, D * (1 + n_ds)] -> final-normed hidden [B, S, D].  With a
        cache, each layer writes its k/v at `cache.offset` in place and the
        cursor advances by S."""
        args = self.args
        D = args.hidden_size
        B, S, width = inputs_embeds.shape
        ds = None
        if width != D:  # channel-packed deepstack prefill
            ds = inputs_embeds[..., D:].reshape(B, S, width // D - 1, D)
            inputs_embeds = inputs_embeds[..., :D]
        cos, sin = self.rope.cos_sin(position_ids)  # [B, S, hd/2]
        h = inputs_embeds
        mp = params["model"]
        eps = args.rms_norm_eps
        dev = inputs_embeds.device
        if cache is None:
            mask = causal_cache_mask(0, torch.zeros((B,), dtype=torch.int32,
                                                    device=dev), S, S)
        else:
            mask = causal_cache_mask(cache.offset, cache.left_pad, S,
                                     cache.capacity)
        for i in range(args.num_hidden_layers):
            lp = layer_view(mp["layers"], i)
            x = rms_norm(lp["input_layernorm"], h, eps)
            h = h + self._attention(lp["self_attn"], x, cos, sin, mask, cache, i)
            x = rms_norm(lp["post_attention_layernorm"], h, eps)
            h = h + self._mlp(lp["mlp"], x)
            if ds is not None and i < ds.shape[2]:
                h = h + ds[:, :, i].to(h.dtype)
        if cache is not None:
            cache.advance(S)
        return rms_norm(mp["norm"], h, eps)

    def _mlp(self, p, x):  # the reference's hook (:127), which the MoE
        return swiglu_mlp(p, x)  # variant overrides

    def _attention(self, p, x, cos, sin, mask, cache, layer):
        B, S, _ = x.shape
        eps = self.args.rms_norm_eps
        q = linear(p["q_proj"], x).reshape(B, S, self.n_heads, self.head_dim)
        k = linear(p["k_proj"], x).reshape(B, S, self.n_kv_heads, self.head_dim)
        v = linear(p["v_proj"], x).reshape(B, S, self.n_kv_heads, self.head_dim)
        q = rms_norm(p["q_norm"], q, eps)
        k = rms_norm(p["k_norm"], k, eps)
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
        q, k = apply_rope(q, k, cos, sin)
        q = q.contiguous()
        if cache is None:
            out = sdpa(q, k, v, self.scale, mask)
        else:
            out = cache.attend(layer, q, k, v, self.scale, mask)
        out = out.transpose(1, 2).reshape(B, S, -1)
        return linear(p["o_proj"], out)

    def step_logits(self, params: dict, inputs_embeds: torch.Tensor,
                    cache: Optional[Cache],
                    position_ids: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V] of a forward step (the per-linear path)."""
        return self.logits(params, self(params, inputs_embeds, cache,
                                        position_ids))

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        if self.args.tie_word_embeddings or "lm_head" not in params:
            return embedding_as_linear(params["model"]["embed_tokens"], hidden)
        return linear(params["lm_head"], hidden)

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        return embedding(params["model"]["embed_tokens"], input_ids)

    def init_cache(self, batch_size: int, capacity: int, dtype=torch.bfloat16,
                   left_pad=None, device=None) -> cache_lib.KVCache:
        return cache_lib.init_cache(
            self.args.num_hidden_layers, batch_size, self.n_kv_heads,
            self.head_dim, capacity, dtype, left_pad, device)

    def get_rope_index(self, input_ids: np.ndarray,
                       image_grid_thw: Optional[np.ndarray] = None,
                       video_grid_thw: Optional[np.ndarray] = None,
                       attention_mask: Optional[np.ndarray] = None):
        cfg = self.config
        if video_grid_thw is not None:
            video_grid_thw = np.repeat(np.asarray(video_grid_thw),
                                       np.asarray(video_grid_thw)[:, 0], axis=0)
            video_grid_thw[:, 0] = 1
        return mrope_position_ids(
            input_ids, image_grid_thw, video_grid_thw, attention_mask,
            merge=cfg.vision_config.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
        )
