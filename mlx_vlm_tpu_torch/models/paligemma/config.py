"""PaliGemma configs.

Port of mlx_vlm_tpu/models/paligemma/config.py (TextConfig :20,
VisionConfig :53, ModelConfig :66), unchanged: gemma's head dim is hidden
/ heads, gemma2's layers alternate sliding (even indices) and full
attention, and `ModelConfig.from_dict` pours the root keys into the
sub-configs, makes the text model bidirectional over the prefix unless it
says otherwise, and falls back to the text model's width for the root
`hidden_size`.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import List, Optional

from ...core.config import BaseModelConfig
from ..clip_vision import VisionConfig as _ClipVisionConfig


@dataclass
class TextConfig(BaseModelConfig):
    model_type: str = "gemma"
    hidden_size: int = 2048
    num_hidden_layers: int = 18
    intermediate_size: int = 8192
    num_attention_heads: int = 16
    num_key_value_heads: Optional[int] = 16
    vocab_size: int = 257152
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    hidden_activation: str = "gelu_pytorch_tanh"
    sliding_window: int = 4096
    layer_types: Optional[List[str]] = None
    use_bidirectional_attention: Optional[bool] = None

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.model_type == "gemma":
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.layer_types is None and self.model_type == "gemma2":
            # even-indexed layers sliding, odd ones full
            self.layer_types = [
                "sliding_attention" if (i + 1) % 2 else "full_attention"
                for i in range(self.num_hidden_layers)
            ]


@dataclass
class VisionConfig(_ClipVisionConfig):
    model_type: str = "siglip_vision_model"
    num_hidden_layers: int = 27
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 2048
    layer_norm_eps: float = 1e-6


@dataclass
class ModelConfig(BaseModelConfig):
    text_config: TextConfig
    vision_config: VisionConfig
    model_type: str = "paligemma"
    vocab_size: int = 257152
    ignore_index: int = -100
    image_token_index: int = 257152
    hidden_size: int = 2048
    pad_token_id: int = 0
    eos_token_id: Optional[List[int]] = None

    @classmethod
    def from_dict(cls, params: dict):
        params = dict(params)
        text = dict(params.get("text_config", {}) or {})
        vision = dict(params.get("vision_config", {}) or {})
        for k, v in params.items():
            if k in TextConfig.__dataclass_fields__ and k not in text:
                text[k] = v
            if k in VisionConfig.__dataclass_fields__ and k not in vision:
                vision[k] = v
        if text.get("use_bidirectional_attention") is None:
            text["use_bidirectional_attention"] = True
        if "hidden_activation" not in text and "hidden_act" in text:
            text["hidden_activation"] = text["hidden_act"]
        if "projection_dim" in params and "projection_dim" not in vision:
            vision["projection_dim"] = params["projection_dim"]
        params["text_config"] = TextConfig.from_dict(text)
        params["vision_config"] = VisionConfig.from_dict(vision)
        # the feature scale divides by the language model's width; the
        # root key may be absent
        if "hidden_size" not in params:
            params["hidden_size"] = params["text_config"].hidden_size
        allowed = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in params.items() if k in allowed})
