"""Text-only fallback: plain language-model checkpoints through the VLM
entry points.

Port of mlx_vlm_tpu/models/text_only.py (_GemmaTextModel :15,
_gemma_text_config :55, _TEXT_ARCHS :77, is_text_only_config :88,
ModelConfig :97, Model :106): llama, mistral, qwen2 (q / k / v biases
picked up from the checkpoint) and qwen3 (per-head q / k norms picked up
the same way) run on models/llama's decoder; gemma and gemma2 on
PaliGemma's (models/paligemma/language.py: (1 + w) norms, the sqrt(D)
embed scale, soft-capping, gemma2's sliding layers), causal unless the
config asks for the bidirectional prefix.
"""

from __future__ import annotations

from typing import Optional

import torch

from .llama import Model as _LlamaModel
from .llama.config import TextConfig as _LlamaConfig
from .llama.llama import text_position_ids
from .paligemma.config import TextConfig as _GemmaConfig
from .paligemma.language import LanguageModel as _GemmaLM


class _GemmaTextModel:
    """gemma / gemma2 text checkpoints through PaliGemma's decoder."""

    def __init__(self, config: _GemmaConfig):
        self.config = config
        self.language_model = _GemmaLM(config)
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

    sanitize = staticmethod(_LlamaModel.sanitize)

    @property
    def stack_patterns(self):
        return ("language_model.model.layers",)

    @property
    def decoder_layers(self) -> int:
        return self.config.num_hidden_layers


class _GemmaConfigFactory:
    @staticmethod
    def from_dict(params: dict) -> _GemmaConfig:
        # text-only gemma is causal (the bidirectional prefix is
        # PaliGemma's)
        p = dict(params)
        p.setdefault("use_bidirectional_attention", False)
        return _GemmaConfig.from_dict(p)


# model_type -> (Model, ModelConfig) of the ported text architectures
_TEXT_ARCHS = {
    "llama": (_LlamaModel, _LlamaConfig),
    "mistral": (_LlamaModel, _LlamaConfig),
    "qwen2": (_LlamaModel, _LlamaConfig),
    "qwen3": (_LlamaModel, _LlamaConfig),
    "gemma": (_GemmaTextModel, _GemmaConfigFactory),
    "gemma2": (_GemmaTextModel, _GemmaConfigFactory),
}


def is_text_only_config(config: dict) -> bool:
    """The reference's rule (:88): no vision or audio config, and a model
    type of the fallback's."""
    return ("vision_config" not in config and "audio_config" not in config
            and config.get("model_type") in _TEXT_ARCHS)


def text_arch(model_type: str) -> tuple:
    """(Model, ModelConfig) of a text-only model type."""
    if model_type not in _TEXT_ARCHS:
        raise ValueError(f"text_only: unsupported model type {model_type}")
    return _TEXT_ARCHS[model_type]


class ModelConfig:
    @classmethod
    def from_dict(cls, params: dict):
        return text_arch(params.get("model_type"))[1].from_dict(params)


def Model(config):
    return text_arch(config.model_type)[0](config)
