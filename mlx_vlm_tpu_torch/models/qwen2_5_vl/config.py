"""Qwen2.5-VL configs.

Port of mlx_vlm_tpu/models/qwen2_5_vl/config.py (VisionConfig :13,
TextConfig :37, ModelConfig :43, from_dict :59-72), unchanged: the text
config is Qwen2-VL's with a tied-embedding default, and `from_dict` merges
root-level text parameters with a nested `text_config`, nested winning.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import List, Optional

from ...core.config import BaseModelConfig
from ..qwen2_vl.config import TextConfig as _Qwen2TextConfig


@dataclass
class VisionConfig(BaseModelConfig):
    model_type: str = "qwen2_5_vl"
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    out_hidden_size: int = 1536
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    vocab_size: int = 32000
    mlp_ratio: float = 4.0
    in_channels: int = 3
    layer_norm_eps: float = 1e-6
    spatial_patch_size: int = 14
    spatial_merge_size: int = 2
    tokens_per_second: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: List[int] = field(
        default_factory=lambda: [7, 15, 23, 31])


@dataclass
class TextConfig(_Qwen2TextConfig):
    tie_word_embeddings: bool = True
    max_position_embeddings: Optional[int] = 128000


@dataclass
class ModelConfig(BaseModelConfig):
    text_config: TextConfig
    vision_config: VisionConfig
    model_type: str = "qwen2_5_vl"
    ignore_index: int = -100
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    vision_token_id: int = 151654
    vision_feature_select_strategy: str = "default"
    vision_feature_layer: int = -2
    vocab_size: int = 32000
    eos_token_id: Optional[List[int]] = None

    @classmethod
    def from_dict(cls, params: dict):
        params = dict(params)
        vision = params.get("vision_config", {}) or {}
        # root-level text params (original checkpoints) overlaid by a nested
        # text_config (transformers >= 4.54 re-saves), nested winning
        text = {k: v for k, v in params.items()
                if k not in ("vision_config", "text_config")}
        nested = params.get("text_config") or {}
        text.update({k: v for k, v in nested.items() if v is not None})
        params["vision_config"] = VisionConfig.from_dict(vision)
        params["text_config"] = TextConfig.from_dict(text)
        allowed = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in params.items() if k in allowed})
