"""Qwen3-VL-MoE language model: Qwen3-VL's decoder with a top-k expert MLP
in every layer.

Port of mlx_vlm_tpu/models/qwen3_vl_moe/qwen3_vl_moe.py (MoELanguageModel
:65-86): the router (softmax, then top-k, renormalised) and `switch_glu`
(core/moe.py) in place of the dense MLP, through the `_mlp` hook of
Qwen3-VL's decoder.  The stacked experts [E, I, D] / [E, D, I] run on K5:
one expert-indexed launch per projection at decode and in short chunks,
per expert on its rows in long prefill chunks (core/moe.py's routes).
"""

from __future__ import annotations

from ...core.moe import switch_glu, topk_router
from ..qwen3_vl.language import LanguageModel
from .config import TextConfig


class MoELanguageModel(LanguageModel):
    def __init__(self, args: TextConfig, config=None):
        super().__init__(args, config)
        self.top_k = args.num_experts_per_tok
        self.norm_topk = args.norm_topk_prob

    def _mlp(self, p, x):
        B, S, D = x.shape
        flat = x.reshape(B * S, D)
        indices, weights = topk_router(flat, p["gate"]["weight"], self.top_k,
                                       self.norm_topk)
        experts = p["experts"]
        out = switch_glu(flat, experts["gate_proj"]["weight"],
                         experts["up_proj"]["weight"],
                         experts["down_proj"]["weight"], indices, weights)
        return out.reshape(B, S, D)
