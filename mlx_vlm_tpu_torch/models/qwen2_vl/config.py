"""Qwen2-VL configs.

Port of mlx_vlm_tpu/models/qwen2_vl/config.py (reference
mlx_vlm/models/qwen2_vl/config.py:1-87), unchanged.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from ...core.config import BaseModelConfig


@dataclass
class VisionConfig(BaseModelConfig):
    model_type: str = "qwen2_vl"
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 1536
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    vocab_size: int = 32000
    mlp_ratio: float = 4.0
    in_channels: int = 3
    layer_norm_eps: float = 1e-6
    spatial_patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2


@dataclass
class TextConfig(BaseModelConfig):
    model_type: str = "qwen2_vl"
    hidden_size: int = 1536
    num_hidden_layers: int = 28
    intermediate_size: int = 8960
    num_attention_heads: int = 12
    rms_norm_eps: float = 1e-6
    vocab_size: int = 151936
    num_key_value_heads: Optional[int] = 2
    max_position_embeddings: Optional[int] = 40960
    rope_theta: float = 1000000.0
    rope_traditional: bool = False
    rope_scaling: Optional[Dict[str, Union[float, str, list]]] = None
    tie_word_embeddings: bool = False
    sliding_window: int = 32768
    use_sliding_window: bool = False
    use_cache: bool = True

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.rope_scaling:
            if "type" not in self.rope_scaling and "rope_type" in self.rope_scaling:
                self.rope_scaling["type"] = self.rope_scaling["rope_type"]
            if self.rope_scaling.get("type") not in ("mrope", "default"):
                raise ValueError("rope_scaling type must be 'mrope' or 'default'")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass
class ModelConfig(BaseModelConfig):
    text_config: TextConfig
    vision_config: VisionConfig
    model_type: str = "qwen2_vl"
    ignore_index: int = -100
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_feature_select_strategy: str = "default"
    vision_feature_layer: int = -2
    vocab_size: int = 151936
    eos_token_id: Optional[List[int]] = None

    @classmethod
    def from_dict(cls, params: dict):
        params = dict(params)
        vision = params.get("vision_config", {}) or {}
        # Text params live at the root level in original HF qwen2_vl
        # config.json (reference config.py:72-86 copies root -> text_config);
        # transformers >= 4.54 re-saves them nested under text_config.
        # Merge both, nested winning (skip nulls so a nested
        # "rope_scaling": null can't clobber a root mrope section).
        text = {
            k: v
            for k, v in params.items()
            if k not in ("vision_config", "text_config")
        }
        nested = params.get("text_config") or {}
        text.update({k: v for k, v in nested.items() if v is not None})
        params["vision_config"] = VisionConfig.from_dict(vision)
        params["text_config"] = TextConfig.from_dict(text)
        allowed = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in params.items() if k in allowed})
