"""Qwen2-VL language model: the Qwen2 decoder with M-RoPE.

Port of mlx_vlm_tpu/models/qwen2_vl/language.py.  Decoder layers run as a
Python loop over views of the stacked weights; the KV cache is written in
place.  `step_logits` carries the reference's whole-stack fused decode
branch (:73-105): a B=1, S=1 step on a plain KVCache runs as one K3 launch
(ops/fused_decode.py) when the loader turned the route on
(`fused_decode`, decided once from MLX_VLM_TPU_FUSED_DECODE and the
reference's eligibility rule); every other step runs the per-linear path.
The logits come back from `step_logits` instead of being stashed on the
instance (the reference's `_fused_logits`, :72-86 and :189-194).  The
pack-only weight unpack (:107-120) is not ported: the port keeps the
per-linear weights only.  `mrope_position_ids` (:230) is copied unchanged
(host numpy, once per prompt), with Qwen2.5-VL's scaling of a video's
time as an option the reference lacks.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ...core import cache as cache_lib
from ...core import turboquant
from ...core.layers import (embedding, embedding_as_linear, linear, rms_norm,
                            swiglu_mlp)
from ...core.mask import causal_cache_mask
from ...core.rope import apply_rope, make_rope
from ...ops.attention import sdpa
from ...ops.fused_decode import fused_decode_step
from ..base import layer_view
from .config import ModelConfig, TextConfig

STACK_PREFIX = "model.layers"

# Any of the caches that generate/ar.py make_cache builds; each writes in
# place at its `offset` in `attend(layer, q, k, v, scale, mask)`.
Cache = Union[cache_lib.KVCache, cache_lib.QuantizedKVCache,
              cache_lib.Int8KVCache, cache_lib.Int4KVCache,
              turboquant.TurboQuantKVCache,
              turboquant.SplitTurboQuantKVCache]


class LanguageModel:
    # the loader's default w4grp layout and the fused decode route (K3)
    # apply to this language model (reference :37)
    supports_fused_decode = True

    def __init__(self, args: TextConfig, config: Optional[ModelConfig] = None):
        self.args = args
        self.config = config
        self.n_heads = args.num_attention_heads
        self.n_kv_heads = args.num_key_value_heads
        self.head_dim = args.hidden_size // args.num_attention_heads
        self.scale = self.head_dim**-0.5
        self.rope = make_rope(self.head_dim, args.rope_theta, args.rope_scaling)
        self.fused_decode = False  # set by the loader

    def __call__(self, params: dict, inputs_embeds: torch.Tensor,
                 cache: Optional[Cache],
                 position_ids: torch.Tensor) -> torch.Tensor:
        """Forward over embeddings [B, S, D] -> final-normed hidden [B, S, D].

        With a cache, each layer writes its k/v at `cache.offset` in place
        and the cursor advances by S.  cache=None runs plain causal attention
        over the S tokens."""
        B, S, _ = inputs_embeds.shape
        cos, sin = self.rope.cos_sin(position_ids)  # [B, S, hd/2]
        h = inputs_embeds
        mp = params["model"]
        eps = self.args.rms_norm_eps
        dev = inputs_embeds.device
        if cache is None:
            mask = causal_cache_mask(0, torch.zeros((B,), dtype=torch.int32,
                                                    device=dev), S, S)
        else:
            mask = causal_cache_mask(cache.offset, cache.left_pad, S,
                                     cache.capacity)
        for i in range(self.args.num_hidden_layers):
            lp = layer_view(mp["layers"], i)
            x = rms_norm(lp["input_layernorm"], h, eps)
            h = h + self._attention(lp["self_attn"], x, cos, sin, mask, cache, i)
            x = rms_norm(lp["post_attention_layernorm"], h, eps)
            h = h + swiglu_mlp(lp["mlp"], x)
        if cache is not None:
            cache.advance(S)
        return rms_norm(mp["norm"], h, eps)

    def _attention(self, p, x, cos, sin, mask, cache, layer):
        B, S, _ = x.shape
        q = linear(p["q_proj"], x).reshape(B, S, self.n_heads, self.head_dim)
        k = linear(p["k_proj"], x).reshape(B, S, self.n_kv_heads, self.head_dim)
        v = linear(p["v_proj"], x).reshape(B, S, self.n_kv_heads, self.head_dim)
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
        """Logits [B, S, V] of a forward step.  With the fused route on, a
        B=1, S=1 step on a plain KVCache is one whole-stack K3 step, which
        reads the cache's cursor tensor on the device, writes its k/v there
        and advances the cursor."""
        B, S, _ = inputs_embeds.shape
        if not (self.fused_decode and B == 1 and S == 1
                and type(cache) is cache_lib.KVCache):
            return self.logits(params,
                               self(params, inputs_embeds, cache, position_ids))
        cos, sin = self.rope.cos_sin(position_ids)  # [1, 1, hd/2]
        outs = fused_decode_step(params, self.args, inputs_embeds, cos[0, 0],
                                 sin[0, 0], cache.k, cache.v, cache.offset)
        cache.advance(1)
        if len(outs) == 4:  # the head ran inside the step
            return outs[3][:, None, :]
        h = rms_norm(params["model"]["norm"], outs[0].to(inputs_embeds.dtype),
                     self.args.rms_norm_eps)
        return self.logits(params, h)

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

    def get_rope_index(self, input_ids: np.ndarray,
                       image_grid_thw: Optional[np.ndarray] = None,
                       video_grid_thw: Optional[np.ndarray] = None,
                       attention_mask: Optional[np.ndarray] = None):
        cfg = self.config
        return mrope_position_ids(
            input_ids, image_grid_thw, video_grid_thw, attention_mask,
            merge=cfg.vision_config.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
        )


def mrope_position_ids(
    input_ids: np.ndarray,  # [B, S]
    image_grid_thw: Optional[np.ndarray] = None,
    video_grid_thw: Optional[np.ndarray] = None,
    attention_mask: Optional[np.ndarray] = None,
    *,
    merge: int,
    image_token_id: int,
    video_token_id: int,
    second_per_grid_ts: Optional[np.ndarray] = None,
    tokens_per_second: float = 1.0,
):
    """3-D (t/h/w) position ids for M-RoPE — host-side, once per prompt.

    Text tokens get sequential positions on all three streams; each vision
    span gets a (t, h, w) grid offset from the running position; positions
    after a span continue from its max + 1.  Returns (position_ids [3,B,S],
    rope_deltas [B,1]).

    With `second_per_grid_ts` (one per video), video i's frame group g
    takes time floor(g * second_per_grid_ts[i] * tokens_per_second), the
    product in float32, as Qwen2.5-VL's get_rope_index computes it
    (transformers' modeling_qwen2_5_vl.py:1061-1097; 4.57.6 casts the
    seconds to an integer before the product, so it agrees only where
    they are whole).  Without it every frame group steps time by one, as
    the reference does for every family."""
    input_ids = np.asarray(input_ids)
    B, S = input_ids.shape
    if image_grid_thw is None and video_grid_thw is None:
        if attention_mask is not None:
            am = np.asarray(attention_mask)
            pos = np.cumsum(am, axis=-1) - 1
            pos = np.where(am == 0, 1, pos)
            deltas = pos.max(axis=-1, keepdims=True) + 1 - S
        else:
            pos = np.broadcast_to(np.arange(S), (B, S)).copy()
            deltas = np.zeros((B, 1), np.int64)
        return (
            np.broadcast_to(pos[None], (3, B, S)).astype(np.int32).copy(),
            deltas.astype(np.int32),
        )

    img_tok, vid_tok = image_token_id, video_token_id
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    attention_mask = np.asarray(attention_mask)
    position_ids = np.ones((3, B, S), np.int32)
    deltas = np.zeros((B, 1), np.int32)
    img_idx = vid_idx = 0
    igrid = None if image_grid_thw is None else np.asarray(image_grid_thw)
    vgrid = None if video_grid_thw is None else np.asarray(video_grid_thw)

    for b in range(B):
        keep = attention_mask[b].astype(bool)
        toks = input_ids[b][keep]
        n = len(toks)
        pos_chunks = []
        st = 0
        cur = 0  # next position value
        while st < n:
            vis_pos = np.nonzero((toks[st:] == img_tok) | (toks[st:] == vid_tok))[0]
            if len(vis_pos) == 0:
                text_len = n - st
                pos_chunks.append(
                    np.broadcast_to(np.arange(text_len) + cur, (3, text_len)))
                cur += text_len
                st = n
                break
            ed = st + int(vis_pos[0])
            if toks[ed] == img_tok:
                t, h, w = igrid[img_idx]
                img_idx += 1
            else:
                t, h, w = vgrid[vid_idx]
                vid_idx += 1
            gt, gh, gw = int(t), int(h) // merge, int(w) // merge
            text_len = ed - st
            if text_len:
                pos_chunks.append(
                    np.broadcast_to(np.arange(text_len) + cur, (3, text_len)))
                cur += text_len
            times = np.arange(gt)
            if toks[ed] == vid_tok and second_per_grid_ts is not None:
                times = (times.astype(np.float32)
                         * np.float32(second_per_grid_ts[vid_idx - 1])
                         * np.float32(tokens_per_second)).astype(np.int64)
            t_idx = np.repeat(times, gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), gt)
            w_idx = np.tile(np.arange(gw), gt * gh)
            pos_chunks.append(np.stack([t_idx, h_idx, w_idx]) + cur)
            cur += max(int(times[-1]) + 1, gh, gw)
            st = ed + gt * gh * gw
        if pos_chunks:
            compact = np.concatenate(pos_chunks, axis=1)  # [3, n]
            full = np.ones((3, S), np.int64)
            full[:, keep] = compact
            position_ids[:, b, :] = full
            deltas[b, 0] = compact.max() + 1 - n
    return position_ids, deltas
