"""EAGLE-3 style drafter: a one-layer speculator over captured target
hidden states.

Port of mlx_vlm_tpu/speculative/drafters/eagle3.py (Eagle3Config :29,
Eagle3Drafter :40, init_cache :55, fuse_features :60, _step :66,
draft_fn :101, init_eagle3_params :123).  The drafter consumes the
concatenation of 3 captured target layers through an fc, then runs a
single llama decoder layer autoregressively, feeding its own hidden state
back as the feature for the next draft position.  Its linears are dense
plain products, as the reference leaves them to XLA.

Its one-layer cache is a `KVCache` written by index at its device cursor,
which each step advances in place, so a draft runs inside a captured
round.  Where the checkpoint omits `embed_tokens` or `lm_head`,
`load_drafter` binds the target (`bind`): rows come through the target's
own `embed` and the head through its `logits`, the values of the target's
table whatever its layout (the reference takes `jnp.take` of the shared
table's `weight` (:73), which a quantized table does not hold).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...core import cache as cache_lib
from ...core.layers import embedding, linear, rms_norm, swiglu_mlp
from ...core.mask import causal_cache_mask
from ...core.rope import apply_rope, make_rope
from ...ops.attention import sdpa

__all__ = ["Eagle3Config", "Eagle3Drafter", "init_eagle3_params",
           "numpy_draw"]


@dataclasses.dataclass
class Eagle3Config:
    hidden_size: int
    intermediate_size: int
    num_attention_heads: int
    num_key_value_heads: int
    vocab_size: int
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    capture_layers: Tuple[int, int, int] = (1, 2, 3)  # target layer indexes


def attend_one(lp: dict, h: torch.Tensor, cache, cos, sin, n_heads: int,
               n_kv_heads: int, head_dim: int, scale: float,
               eps: float) -> torch.Tensor:
    """One llama block over one new position per row (h [B, 1, D]):
    its K/V written at the one-layer cache's cursor, attention over the
    cache below and at it; the cursor advances by one."""
    B = h.shape[0]
    y = rms_norm(lp["input_layernorm"], h, eps)
    a = lp["self_attn"]
    q = linear(a["q_proj"], y).reshape(B, 1, n_heads, head_dim).transpose(1, 2)
    k = linear(a["k_proj"], y).reshape(B, 1, n_kv_heads,
                                       head_dim).transpose(1, 2)
    v = linear(a["v_proj"], y).reshape(B, 1, n_kv_heads,
                                       head_dim).transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)
    mask = causal_cache_mask(cache.offset, cache.left_pad, 1, cache.capacity)
    kb, vb = cache.k[0], cache.v[0]
    cache_lib.update_layer(kb, vb, k, v, cache.offset)
    out = sdpa(q.contiguous(), kb, vb, scale, mask)
    h = h + linear(a["o_proj"], out.transpose(1, 2).reshape(B, 1, -1))
    y = rms_norm(lp["post_attention_layernorm"], h, eps)
    cache.advance(1)
    return h + swiglu_mlp(lp["mlp"], y)


class Eagle3Drafter:
    """params = {"fc": Linear(3D -> D), "embed_tokens"?, "midlayer" (llama
    layer: input_layernorm / self_attn / post_attention_layernorm / mlp),
    "norm", "lm_head"?}."""

    def __init__(self, config: Eagle3Config):
        self.config = config
        c = config
        self.n_heads = c.num_attention_heads
        self.n_kv_heads = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.scale = self.head_dim**-0.5
        self.rope = make_rope(self.head_dim, c.rope_theta)
        self.target = None  # (language model, its params) once bound

    def bind(self, target_lm, target_params: dict) -> None:
        """Take the rows and the head that the checkpoint omits from the
        target's language model (`embed` / `logits` on its params)."""
        self.target = (target_lm, target_params)

    def init_cache(self, batch_size: int, capacity: int,
                   dtype=torch.float32, device=None) -> cache_lib.KVCache:
        return cache_lib.init_cache(1, batch_size, self.n_kv_heads,
                                    self.head_dim, capacity, dtype, None,
                                    device)

    def fuse_features(self, params: dict,
                      hiddens: torch.Tensor) -> torch.Tensor:
        """hiddens [L, B, S, D] (captured target stack) -> features
        [B, S, D]."""
        picks = [hiddens[i] for i in self.config.capture_layers]
        return linear(params["fc"], torch.cat(picks, dim=-1))

    def embed(self, params: dict, tok: torch.Tensor) -> torch.Tensor:
        if "embed_tokens" in params:
            return embedding(params["embed_tokens"], tok)
        lm, lp = self.target
        return lm.embed(lp, tok)

    def head(self, params: dict, hn: torch.Tensor) -> torch.Tensor:
        if "lm_head" in params:
            return linear(params["lm_head"], hn)
        lm, lp = self.target
        return lm.logits(lp, hn)

    def _block_input(self, params: dict, tok: torch.Tensor,
                     feature: torch.Tensor) -> torch.Tensor:
        # EAGLE conditioning: token embedding + fused feature
        return self.embed(params, tok) + feature

    def step(self, params: dict, cache, tok: torch.Tensor,
             feature: torch.Tensor, pos: torch.Tensor) -> tuple:
        """One draft step at position `pos` (0-dim device tensor):
        (token [B], feature [B, D]) -> (logits [B, V], next feature
        [B, D]); the cache's cursor advances by one."""
        c = self.config
        x = self._block_input(params, tok, feature)[:, None, :]
        B = x.shape[0]
        cos, sin = self.rope.cos_sin(pos.reshape(1, 1).expand(B, 1))
        h = attend_one(self._layer(params), x, cache, cos, sin, self.n_heads,
                       self.n_kv_heads, self.head_dim, self.scale,
                       c.rms_norm_eps)
        hn = rms_norm(params["norm"], h, c.rms_norm_eps)
        return self.head(params, hn)[:, 0], h[:, 0]

    def _layer(self, params: dict) -> dict:
        return params["midlayer"]

    def draft_fn(self, k_steps: int) -> Callable:
        """draft(params, cache, tok [B], feature [B, D], start_pos) -> draft
        tokens [B, k_steps]: k greedy steps at positions start_pos + i, the
        cache written in place (its cursor advances by k)."""

        def draft(params, cache, tok, feature, start_pos):
            toks = []
            for i in range(k_steps):
                logits, feature = self.step(params, cache, tok, feature,
                                            start_pos + i)
                tok = torch.argmax(logits, dim=-1)
                toks.append(tok)
            return torch.stack(toks, dim=1)

        return draft


def numpy_draw(seed: int, scale: float, dtype, device) -> Callable:
    """The reference's draw: rng.standard_normal(shape) * scale from a
    numpy Generator seeded `seed`, in call order, as a tensor."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        a = rng.standard_normal(shape) * scale
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return rand


def init_eagle3_params(config: Eagle3Config, seed: int = 0,
                       scale: float = 0.05, dtype=torch.float32, device=None,
                       draw: Optional[Callable] = None) -> dict:
    """Random drafter params, the reference's numpy draws in its order
    (checkpoint loading maps the same tree); `draw(*shape)` replaces the
    draw (a generator on the card, for full-width drafters)."""
    rand = draw or numpy_draw(seed, scale, dtype, device)
    c = config
    D, I, V = c.hidden_size, c.intermediate_size, c.vocab_size
    hd = D // c.num_attention_heads

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    return {
        "fc": {"weight": rand(D, 3 * D)},
        "embed_tokens": {"weight": rand(V, D)},
        "midlayer": {
            "input_layernorm": {"weight": ones(D)},
            "post_attention_layernorm": {"weight": ones(D)},
            "self_attn": {
                "q_proj": {"weight": rand(c.num_attention_heads * hd, D)},
                "k_proj": {"weight": rand(c.num_key_value_heads * hd, D)},
                "v_proj": {"weight": rand(c.num_key_value_heads * hd, D)},
                "o_proj": {"weight": rand(D, c.num_attention_heads * hd)},
            },
            "mlp": {
                "gate_proj": {"weight": rand(I, D)},
                "up_proj": {"weight": rand(I, D)},
                "down_proj": {"weight": rand(D, I)},
            },
        },
        "norm": {"weight": ones(D)},
        "lm_head": {"weight": rand(V, D)},
    }
