"""Qwen3-VL-MoE configs.

Port of mlx_vlm_tpu/models/qwen3_vl_moe/qwen3_vl_moe.py (TextConfig :27,
its refusal of mixed layers :40-48, ModelConfig :51): Qwen3-VL's configs
with the expert fields.  The text defaults are Qwen3-VL-30B-A3B's expert
widths (128 experts, 8 a token, width 768); a checkpoint's config.json
sets its own.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import List

from ..qwen3_vl.config import ModelConfig as _VLModelConfig
from ..qwen3_vl.config import TextConfig as _VLTextConfig
from ..qwen3_vl.config import VisionConfig


@dataclass
class TextConfig(_VLTextConfig):
    model_type: str = "qwen3_vl_moe_text"
    num_experts: int = 128
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768
    norm_topk_prob: bool = True
    decoder_sparse_step: int = 1
    mlp_only_layers: List[int] = field(default_factory=list)

    def __post_init__(self):
        super().__post_init__()
        if self.mlp_only_layers or self.decoder_sparse_step != 1:
            # as the reference: every released qwen3_vl_moe checkpoint is
            # all-MoE, and its scanned decoder needs homogeneous layers
            raise ValueError(
                "qwen3_vl_moe requires every layer to be MoE "
                "(decoder_sparse_step == 1, mlp_only_layers == [])")


@dataclass
class ModelConfig(_VLModelConfig):
    model_type: str = "qwen3_vl_moe"

    @classmethod
    def from_dict(cls, params: dict):
        params = dict(params)
        params["vision_config"] = VisionConfig.from_dict(
            params.get("vision_config", {}) or {})
        params["text_config"] = TextConfig.from_dict(
            params.get("text_config", {}) or {})
        allowed = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in params.items() if k in allowed})
