"""Qwen3-VL configs.

Port of mlx_vlm_tpu/models/qwen3_vl/config.py (VisionConfig :12,
TextConfig :30, ModelConfig :59), unchanged.  The text defaults are the
2B's widths; a checkpoint's config.json sets its own.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from ...core.config import BaseModelConfig


@dataclass
class VisionConfig(BaseModelConfig):
    model_type: str = "qwen3_vl"
    depth: int = 27
    hidden_size: int = 1152
    intermediate_size: int = 4304
    out_hidden_size: int = 2048
    num_heads: int = 16
    patch_size: int = 16
    in_channels: int = 3
    layer_norm_eps: float = 1e-6
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    num_position_embeddings: int = 2304
    deepstack_visual_indexes: List[int] = field(default_factory=lambda: [])
    hidden_act: str = "gelu_pytorch_tanh"


@dataclass
class TextConfig(BaseModelConfig):
    model_type: str = "qwen3_vl_text"
    hidden_size: int = 2048
    num_hidden_layers: int = 28
    intermediate_size: int = 6144
    num_attention_heads: int = 16
    num_key_value_heads: Optional[int] = 8
    head_dim: Optional[int] = 128
    rms_norm_eps: float = 1e-6
    vocab_size: int = 151936
    rope_theta: float = 5000000.0
    max_position_embeddings: int = 262144
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    rope_scaling: Optional[Dict[str, Union[float, str, bool, List[int]]]] = field(
        default_factory=lambda: {"type": "default", "mrope_section": [24, 20, 20]}
    )

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.rope_scaling and "type" not in self.rope_scaling:
            if "rope_type" in self.rope_scaling:
                self.rope_scaling["type"] = self.rope_scaling["rope_type"]


@dataclass
class ModelConfig(BaseModelConfig):
    text_config: TextConfig
    vision_config: VisionConfig
    model_type: str = "qwen3_vl"
    ignore_index: int = -100
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_id: Optional[List[int]] = None

    @classmethod
    def from_dict(cls, params: dict):
        params = dict(params)
        params["vision_config"] = VisionConfig.from_dict(
            params.get("vision_config", {}) or {})
        params["text_config"] = TextConfig.from_dict(
            params.get("text_config", {}) or {})
        allowed = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in params.items() if k in allowed})
