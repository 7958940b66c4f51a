"""GPT-OSS config.

Port of mlx_vlm_tpu/models/gpt_oss/config.py (TextConfig :14), unchanged:
the defaults are gpt-oss-120b's depth and experts at gpt-oss's shared
widths; a checkpoint's config.json sets its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

from ...core.config import BaseModelConfig


@dataclass
class TextConfig(BaseModelConfig):
    model_type: str = "gpt_oss"
    num_hidden_layers: int = 36
    num_local_experts: int = 128
    num_experts_per_tok: int = 4
    vocab_size: int = 201088
    rms_norm_eps: float = 1e-5
    hidden_size: int = 2880
    intermediate_size: int = 2880
    head_dim: int = 64
    num_attention_heads: int = 64
    num_key_value_heads: int = 8
    sliding_window: int = 128
    rope_theta: float = 150000.0
    rope_scaling: Any = None
    layer_types: Optional[List[str]] = None
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = False
    eos_token_id: Any = None


ModelConfig = TextConfig
