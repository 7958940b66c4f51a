"""DFlash drafter: block-parallel draft denoising over captured target
hidden states.

Port of mlx_vlm_tpu/speculative/drafters/dflash.py (DFlashConfig :42,
DFlashDrafter :65, init_cache :84, fuse_ctx :89, _ctx_embed :95, _ctx_kv
:102, append_fn :119, draft_fn :150, draft_logits_fn :215,
next_block_size :281, init_dflash_params :302).  A small qwen3-style
transformer drafts a whole block of tokens in one non-autoregressive
forward: the proposal block [bonus, mask, mask, ...] attends to a running
context of fused target hidden states; the logits come from the target's
own head, the rows of the block from its own embedding.

The context K/V live in a `KVCache` written by index at its device
cursor.  An append writes `seg_len` rows at the cursor and advances it by
the valid count (a device tensor or an int): the rows past the valid
count are padding, which the next append overwrites.  The block attends to
the cache below the cursor and to the whole block (non-causal within it,
as DFlash denoises the block jointly); its own K/V are used in flight and
never stored.  Both keep the reference's semantics, which decide what is
drafted.  Its linears are dense plain products; the head and the
embedding are the target's (K5 on an exact target).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ...core import cache as cache_lib
from ...core.layers import linear, rms_norm, swiglu_mlp
from ...core.rope import apply_rope, make_rope
from ...ops.attention import sdpa
from ...models.base import layer_view
from .eagle3 import numpy_draw

__all__ = ["DFlashConfig", "DFlashDrafter", "next_block_size",
           "init_dflash_params", "stack_trees"]


@dataclasses.dataclass
class DFlashConfig:
    hidden_size: int
    intermediate_size: int
    num_attention_heads: int
    num_key_value_heads: int
    vocab_size: int
    num_hidden_layers: int = 5
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000000.0
    mask_token_id: int = 0
    block_size: int = 16
    target_layer_ids: Tuple[int, ...] = (1, 8, 15, 22, 29)
    target_hidden_size: Optional[int] = None  # per captured target layer

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.target_hidden_size is None:
            self.target_hidden_size = self.hidden_size


class DFlashDrafter:
    """params = {"fc": Linear(nc*Dt -> D), "hidden_norm", "layers"
    (stacked: input_layernorm / self_attn{q,k,v,o,q_norm,k_norm} /
    post_attention_layernorm / mlp), "norm"}.  Embeddings and head are
    the target's at draft time (reference bind(), dflash.py:143)."""

    def __init__(self, config: DFlashConfig):
        self.config = config
        c = config
        self.n_heads = c.num_attention_heads
        self.n_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        self.scale = self.head_dim**-0.5
        self.rope = make_rope(self.head_dim, c.rope_theta)

    def init_cache(self, batch_size: int, capacity: int,
                   dtype=torch.float32, device=None) -> cache_lib.KVCache:
        return cache_lib.init_cache(
            self.config.num_hidden_layers, batch_size, self.n_kv_heads,
            self.head_dim, capacity, dtype, None, device)

    def fuse_ctx(self, hiddens: torch.Tensor) -> torch.Tensor:
        """[L, B, S, Dt] captured target stack -> [B, S, nc*Dt]."""
        return torch.cat([hiddens[i] for i in self.config.target_layer_ids],
                         dim=-1)

    # ------------------------------------------------------------ internals
    def _ctx_embed(self, params: dict, ctx: torch.Tensor) -> torch.Tensor:
        """Fused target hidden -> drafter context stream [B, T, D]."""
        return rms_norm(params["hidden_norm"], linear(params["fc"], ctx),
                        self.config.rms_norm_eps)

    def _ctx_kv(self, lp: dict, x_ctx: torch.Tensor, cos, sin) -> tuple:
        """One layer's context K/V for appending: [B, Hkv, T, hd] each."""
        B, T, _ = x_ctx.shape
        eps = self.config.rms_norm_eps
        y = rms_norm(lp["input_layernorm"], x_ctx, eps)
        a = lp["self_attn"]
        k = linear(a["k_proj"], y).reshape(B, T, self.n_kv_heads,
                                           self.head_dim)
        k = rms_norm(a["k_norm"], k, eps).transpose(1, 2)
        v = linear(a["v_proj"], y).reshape(B, T, self.n_kv_heads,
                                           self.head_dim).transpose(1, 2)
        _, k = apply_rope(k, k, cos, sin)
        return k, v

    # -------------------------------------------------------------- appends
    def append_fn(self, seg_len: int) -> Callable:
        """append(params, cache, ctx [B, seg_len, nc*Dt], n_valid): write
        `seg_len` context rows at the cursor and advance it by `n_valid`
        (an int or an int device tensor).  Rows >= n_valid are padding:
        they land past the advanced cursor and the next append overwrites
        them."""

        def append(params, cache, ctx, n_valid):
            B = ctx.shape[0]
            x_ctx = self._ctx_embed(params, ctx)
            pos = cache.offset.long() + torch.arange(seg_len,
                                                     device=ctx.device)
            cos, sin = self.rope.cos_sin(pos[None].expand(B, seg_len))
            for i in range(self.config.num_hidden_layers):
                k, v = self._ctx_kv(layer_view(params["layers"], i), x_ctx,
                                    cos, sin)
                cache_lib.update_layer(cache.k[i], cache.v[i], k, v,
                                       cache.offset)
            if isinstance(n_valid, torch.Tensor):
                cache.offset.add_(n_valid.to(cache.offset.dtype))
            else:
                cache.advance(int(n_valid))

        return append

    # --------------------------------------------------------------- drafts
    def _block_hidden(self, target_lm, tparams: dict, params: dict, cache,
                      bonus: torch.Tensor, bs: int) -> torch.Tensor:
        """The drafter's final-normed hidden over the block [bonus, mask x
        (bs - 1)] -> [B, bs, D]; the cache is read, not written."""
        c = self.config
        B = bonus.shape[0]
        tlp = tparams["language_model"]
        block = torch.cat([bonus[:, None].long(),
                           torch.full((B, bs - 1), c.mask_token_id,
                                      dtype=torch.long, device=bonus.device)],
                          dim=1)
        h = target_lm.embed(tlp, block)  # [B, bs, D]
        pos = cache.offset.long() + torch.arange(bs, device=bonus.device)
        cos, sin = self.rope.cos_sin(pos[None].expand(B, bs))
        C = cache.capacity
        # [1, 1, 1, C + bs]: context valid below the cursor, block fully
        # visible (non-causal denoising)
        mask = torch.cat([
            torch.arange(C, device=bonus.device) < cache.offset,
            torch.ones((bs,), dtype=torch.bool, device=bonus.device)
        ])[None, None, None, :]
        eps = c.rms_norm_eps
        for i in range(c.num_hidden_layers):
            lp = layer_view(params["layers"], i)
            kc, vc = cache.k[i], cache.v[i]
            a = lp["self_attn"]
            y = rms_norm(lp["input_layernorm"], h, eps)
            q = linear(a["q_proj"], y).reshape(B, bs, self.n_heads,
                                               self.head_dim)
            q = rms_norm(a["q_norm"], q, eps).transpose(1, 2)
            pk = linear(a["k_proj"], y).reshape(B, bs, self.n_kv_heads,
                                                self.head_dim)
            pk = rms_norm(a["k_norm"], pk, eps).transpose(1, 2)
            pv = linear(a["v_proj"], y).reshape(
                B, bs, self.n_kv_heads, self.head_dim).transpose(1, 2)
            q, pk = apply_rope(q, pk, cos, sin)
            keys = torch.cat([kc, pk.to(kc.dtype)], dim=2)
            vals = torch.cat([vc, pv.to(vc.dtype)], dim=2)
            o = sdpa(q.contiguous(), keys, vals, self.scale, mask)
            o = o.transpose(1, 2).reshape(B, bs, -1)
            h = h + linear(a["o_proj"], o)
            y2 = rms_norm(lp["post_attention_layernorm"], h, eps)
            h = h + swiglu_mlp(lp["mlp"], y2)
        return rms_norm(params["norm"], h, eps)

    def draft_logits_fn(self, target_lm, block_size: int) -> Callable:
        """draft_logits(target params, params, cache, bonus [B]) -> f32
        logits [B, block_size - 1, V] of positions 1..bs-1 through the
        target's head (they feed DDTree's `build_ddtree`)."""

        def draft_logits(tparams, params, cache, bonus):
            h = self._block_hidden(target_lm, tparams, params, cache, bonus,
                                   block_size)
            return target_lm.logits(tparams["language_model"],
                                    h[:, 1:]).float()

        return draft_logits

    def draft_fn(self, target_lm, block_size: int) -> Callable:
        """draft(target params, params, cache, bonus [B]) -> the block's
        greedy draft tokens [B, block_size - 1]."""
        logits = self.draft_logits_fn(target_lm, block_size)

        def draft(tparams, params, cache, bonus):
            return torch.argmax(logits(tparams, params, cache, bonus),
                                dim=-1)

        return draft


def stack_trees(trees: list):
    """Parameter trees of one structure -> one tree, each leaf the
    leaves stacked on a new leading (layer) axis."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def next_block_size(stats, ceiling: int, remaining: int,
                    window: int = 8) -> int:
    """Acceptance-adaptive block sizing (reference :281): back off fast
    when deep positions are rejected, grow back on sustained near-full
    acceptance.  Sizes snap to {4, 8, ceiling}, so at most three verify
    programs are captured."""
    bs = min(ceiling, remaining)
    if bs <= 1:
        return bs
    recent = stats.recent[-window:]
    if not recent:
        return bs
    drafted = sum(d for _, d in recent)
    accepted = sum(a for a, _ in recent)
    rate = accepted / max(drafted, 1)
    if rate < 0.30:
        return min(bs, 4)
    if rate < 0.60:
        return min(bs, 8)
    return bs


def init_dflash_params(config: DFlashConfig, seed: int = 0,
                       scale: float = 0.05, dtype=torch.float32, device=None,
                       draw: Optional[Callable] = None) -> dict:
    """Random drafter params (the reference's numpy draws in its order:
    each layer whole, then stacked), the layers stacked on a leading
    axis; `draw(*shape)` replaces the draw."""
    rand = draw or numpy_draw(seed, scale, dtype, device)
    c = config
    D, I = c.hidden_size, c.intermediate_size
    hd = c.head_dim
    nc = len(c.target_layer_ids)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def one_layer():
        return {
            "input_layernorm": {"weight": ones(D)},
            "post_attention_layernorm": {"weight": ones(D)},
            "self_attn": {
                "q_proj": {"weight": rand(c.num_attention_heads * hd, D)},
                "k_proj": {"weight": rand(c.num_key_value_heads * hd, D)},
                "v_proj": {"weight": rand(c.num_key_value_heads * hd, D)},
                "o_proj": {"weight": rand(D, c.num_attention_heads * hd)},
                "q_norm": {"weight": ones(hd)},
                "k_norm": {"weight": ones(hd)},
            },
            "mlp": {
                "gate_proj": {"weight": rand(I, D)},
                "up_proj": {"weight": rand(I, D)},
                "down_proj": {"weight": rand(D, I)},
            },
        }

    fc = rand(D, nc * c.target_hidden_size)
    return {
        "fc": {"weight": fc},
        "hidden_norm": {"weight": ones(D)},
        "layers": stack_trees([one_layer()
                               for _ in range(c.num_hidden_layers)]),
        "norm": {"weight": ones(D)},
    }
