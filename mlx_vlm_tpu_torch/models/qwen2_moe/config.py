"""Qwen-MoE text config (Qwen1.5-MoE / Qwen2-MoE, and Qwen3-MoE through the
loader's remapping).

Port of mlx_vlm_tpu/models/qwen2_moe/config.py (TextConfig :14), unchanged:
the llama config with the expert fields; the defaults are
Qwen1.5-MoE-A2.7B's expert widths (60 experts, 4 a token, width 1408, a
shared expert of 5632).  A checkpoint's config.json sets its own.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..llama.config import TextConfig as _LlamaText


@dataclass
class TextConfig(_LlamaText):
    model_type: str = "qwen2_moe"
    num_experts: int = 60
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    norm_topk_prob: bool = False
    decoder_sparse_step: int = 1
    attention_bias: bool = True


ModelConfig = TextConfig
