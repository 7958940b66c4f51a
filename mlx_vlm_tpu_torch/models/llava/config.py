"""LLaVA configs.

Port of mlx_vlm_tpu/models/llava/config.py (ModelConfig :16), unchanged.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import List, Optional

from ...core.config import BaseModelConfig
from ..clip_vision import VisionConfig
from ..llama.config import TextConfig


@dataclass
class ModelConfig(BaseModelConfig):
    text_config: TextConfig
    vision_config: VisionConfig
    model_type: str = "llava"
    ignore_index: int = -100
    image_token_index: int = 32000
    vision_feature_select_strategy: str = "default"
    vision_feature_layer: int = -2
    vocab_size: int = 32000
    eos_token_id: Optional[List[int]] = None
    projector_hidden_act: str = "gelu"

    @classmethod
    def from_dict(cls, params: dict):
        params = dict(params)
        params["vision_config"] = VisionConfig.from_dict(
            params.get("vision_config", {}) or {})
        params["text_config"] = TextConfig.from_dict(
            params.get("text_config", {}) or {})
        allowed = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in params.items() if k in allowed})
