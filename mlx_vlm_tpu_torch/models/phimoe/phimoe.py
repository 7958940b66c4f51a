"""PhiMoE (Phi-3.5-MoE) text model.

Port of mlx_vlm_tpu/models/phimoe/phimoe.py (TextConfig :26,
PhiMoELanguageModel :44-61, sanitize :72): the Qwen-MoE decoder with
LayerNorm block norms (the `_norm` hook; weights and biases), biased q /
k / v / o projections and a biased lm_head, and the su / longrope rope of
core/rope.py (the long factors and mscale, `original_max_position_embeddings`
from the config where the scaling leaves it out).  Its routing is the
reference's top-k-then-softmax, and its checkpoint keys are mixtral's.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...core.layers import layer_norm, linear
from ...core.rope import make_rope
from ..mixtral.mixtral import Model as _MixtralModel
from ..qwen2_moe.config import TextConfig as _MoEText
from ..qwen2_moe.language import MoELanguageModel


@dataclass
class TextConfig(_MoEText):
    model_type: str = "phimoe"
    num_local_experts: int = 16
    num_experts_per_tok: int = 2
    norm_topk_prob: bool = True  # softmax over the selected experts
    attention_bias: bool = True
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    original_max_position_embeddings: int = 4096

    def __post_init__(self):
        super().__post_init__()
        self.num_experts = self.num_local_experts


ModelConfig = TextConfig


class PhiMoELanguageModel(MoELanguageModel):
    def __init__(self, args: TextConfig, config=None):
        super().__init__(args, config)
        self._norm = layer_norm
        if args.rope_scaling and "short_factor" in args.rope_scaling:
            scaling = dict(args.rope_scaling)
            scaling.setdefault("rope_type", "longrope")
            scaling.setdefault("original_max_position_embeddings",
                               args.original_max_position_embeddings)
            self.rope = make_rope(self.head_dim, args.rope_theta, scaling,
                                  args.max_position_embeddings)

    def logits(self, params: dict, hidden):
        return linear(params["lm_head"], hidden)  # biased head


class Model(_MixtralModel):
    language_model_class = PhiMoELanguageModel
