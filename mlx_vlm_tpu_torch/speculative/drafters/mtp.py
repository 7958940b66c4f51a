"""MTP (multi-token prediction) drafter: one decoder block conditioned on
[enorm(embed(token)) | hnorm(target hidden)] -> eh_proj.

Port of mlx_vlm_tpu/speculative/drafters/mtp.py (MTPConfig :34,
MTPDrafter :45, fuse_features :65, _step :69, draft_fn :108,
init_mtp_params :130): the drafter head shipped inside MTP-trained
checkpoints, whose token embedding and lm_head are shared with the target.
It duck-types `Eagle3Drafter` (init_cache / fuse_features / step /
draft_fn), so `eagle3_generate_step` drives either kind; it conditions on
the target's last layer output alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ...core.layers import linear, rms_norm
from .eagle3 import Eagle3Drafter, numpy_draw

__all__ = ["MTPConfig", "MTPDrafter", "init_mtp_params"]


@dataclasses.dataclass
class MTPConfig:
    hidden_size: int
    intermediate_size: int
    num_attention_heads: int
    num_key_value_heads: int
    vocab_size: int
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0


class MTPDrafter(Eagle3Drafter):
    """params = {"enorm", "hnorm", "eh_proj" (2D -> D), "layer" (llama
    block), "norm", "embed_tokens"?, "lm_head"?}: the last two usually
    shared from the target (`bind`)."""

    def fuse_features(self, params: dict,
                      hiddens: torch.Tensor) -> torch.Tensor:
        """MTP conditions on the target's final layer output only."""
        return hiddens[-1]

    def _block_input(self, params: dict, tok: torch.Tensor,
                     feature: torch.Tensor) -> torch.Tensor:
        eps = self.config.rms_norm_eps
        e = rms_norm(params["enorm"], self.embed(params, tok), eps)
        hcond = rms_norm(params["hnorm"], feature, eps)
        return linear(params["eh_proj"], torch.cat([e, hcond], dim=-1))

    def _layer(self, params: dict) -> dict:
        return params["layer"]


def init_mtp_params(config: MTPConfig, seed: int = 0, scale: float = 0.05,
                    dtype=torch.float32, device=None,
                    shared_embed: Optional[torch.Tensor] = None,
                    shared_lm_head: Optional[torch.Tensor] = None,
                    draw: Optional[Callable] = None) -> dict:
    """Random drafter params in the reference's draw order; pass the
    target's embed / lm_head weights to share them (reference bind())."""
    rand = draw or numpy_draw(seed, scale, dtype, device)
    c = config
    D, I, V = c.hidden_size, c.intermediate_size, c.vocab_size
    hd = D // c.num_attention_heads

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    return {
        "enorm": {"weight": ones(D)},
        "hnorm": {"weight": ones(D)},
        "eh_proj": {"weight": rand(D, 2 * D)},
        "embed_tokens": {
            "weight": shared_embed if shared_embed is not None else rand(V, D)
        },
        "layer": {
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
        "lm_head": {
            "weight": shared_lm_head if shared_lm_head is not None
            else rand(V, D)
        },
    }
