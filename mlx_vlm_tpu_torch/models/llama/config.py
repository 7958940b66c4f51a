"""Llama-family text config.

Port of mlx_vlm_tpu/models/llama/config.py (TextConfig :12), unchanged:
the defaults are Llama-3-8B's widths; a checkpoint's config.json sets its
own (Llama-2's through LLaVA's text_config, mistral, qwen2 and qwen3
through `text_only`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from ...core.config import BaseModelConfig


@dataclass
class TextConfig(BaseModelConfig):
    model_type: str = "llama"
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    intermediate_size: int = 14336
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    vocab_size: int = 128256
    rope_theta: float = 500000.0
    rope_traditional: bool = False
    rope_scaling: Optional[Dict[str, Union[float, str, list]]] = None
    attention_bias: bool = False
    mlp_bias: bool = False
    partial_rotary_factor: float = 1.0
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 131072
    eos_token_id: Optional[Union[int, List[int]]] = None

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads


ModelConfig = TextConfig
