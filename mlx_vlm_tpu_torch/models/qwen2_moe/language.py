"""Qwen-MoE decoder: the llama decoder with a top-k expert MLP and, where
the checkpoint has one, a gated shared expert.

Port of mlx_vlm_tpu/models/qwen2_moe/language.py (MoELanguageModel :18,
_mlp :24-44) through the llama decoder's `_mlp` hook: the router (softmax,
top-k, renormalised when `norm_topk_prob`) and `switch_glu` (core/moe.py)
over the stacked experts [E, I, D] / [E, D, I], plus the shared expert's
SwiGLU scaled by sigmoid(shared_expert_gate(x)) taken in f32.  On the card
the experts run on K5 (one expert-indexed launch a projection at decode
and inside a capture, K5 per expert with rows in long prefill chunks); the
shared expert and its gate are linears of the runtime mode, and the gate's
sigmoid is elementwise on the device, so a captured step reads nothing on
the host.
"""

from __future__ import annotations

import torch

from ...core.layers import linear, swiglu_mlp
from ...core.moe import switch_glu, topk_router
from ..llama.language import LanguageModel
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
        if "shared_expert" in p:
            shared = swiglu_mlp(p["shared_expert"], flat)
            gate = torch.sigmoid(linear(p["shared_expert_gate"], flat).float())
            out = out + gate.to(shared.dtype) * shared
        return out.reshape(B, S, D)
