"""Llama top-level (text-only) model.

Port of mlx_vlm_tpu/models/llama/llama.py (text_position_ids :20, Model
:40, sanitize :58): plain sequential positions as [3, B, S] ids plus
deltas, so that generate_step, BatchGenerator, the server and prefix
caching take it as they take the Qwen-VL models.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import ModelConfig
from .language import LanguageModel

STACK_PATTERNS = ("language_model.model.layers",)


def text_position_ids(input_ids: np.ndarray, attention_mask=None):
    """[3, B, S] positions + deltas [B, 1] for plain sequential rope
    (left-pad aware: padded columns at 0)."""
    B, S = np.asarray(input_ids).shape
    if attention_mask is not None:
        am = np.asarray(attention_mask)
        pos = np.cumsum(am, axis=-1) - 1
        pos = np.where(am == 0, 0, pos)
        deltas = pos.max(axis=-1, keepdims=True) + 1 - S
    else:
        pos = np.broadcast_to(np.arange(S), (B, S))
        deltas = np.zeros((B, 1), np.int64)
    return (
        np.broadcast_to(pos[None], (3, B, S)).astype(np.int32).copy(),
        deltas.astype(np.int32),
    )


class Model:
    language_model_class = LanguageModel  # derived families set their own

    def __init__(self, config: ModelConfig):
        self.config = config
        self.language_model = self.language_model_class(config)
        self.params: dict = {}  # set by the loader
        self.config_dict: dict = {}
        self.device: Optional[torch.device] = None  # set by the loader

    def get_input_embeddings(self, params: dict, input_ids: torch.Tensor,
                             pixel_values=None, **aux) -> torch.Tensor:
        return self.language_model.embed(params["language_model"], input_ids)

    def __call__(self, params: dict, inputs_embeds: torch.Tensor, cache,
                 position_ids: torch.Tensor) -> torch.Tensor:
        """Forward over embeddings -> logits [B, S, V] (cache written in
        place)."""
        return self.language_model.step_logits(
            params["language_model"], inputs_embeds, cache, position_ids)

    def prepare_position_ids(self, input_ids, image_grid_thw=None,
                             video_grid_thw=None, attention_mask=None):
        return text_position_ids(input_ids, attention_mask)

    def vision_aux_inputs(self, grid_thw) -> dict:
        return {}

    @staticmethod
    def sanitize(weights: dict) -> dict:
        out = {}
        for k, v in weights.items():
            if "rotary_emb.inv_freq" in k:
                continue
            if not k.startswith("language_model."):
                k = "language_model." + k
            out[k] = v
        return out

    @property
    def stack_patterns(self):
        return STACK_PATTERNS

    @property
    def decoder_layers(self) -> int:
        return self.config.num_hidden_layers
