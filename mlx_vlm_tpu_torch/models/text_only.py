"""Text-only fallback: plain language-model checkpoints through the VLM
entry points.

Port of mlx_vlm_tpu/models/text_only.py (_TEXT_ARCHS :77,
is_text_only_config :88, ModelConfig :97, Model :106) for the
llama-architecture types: llama, mistral, qwen2 (q / k / v biases picked
up from the checkpoint) and qwen3 (per-head q / k norms picked up the same
way) run on models/llama's decoder.  gemma and gemma2 run on paligemma's
decoder in the reference (:15-73), which is not ported: `text_arch`
raises NotImplementedError for them (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from .llama import Model as _LlamaModel
from .llama.config import TextConfig as _LlamaConfig

# model_type -> (Model, ModelConfig) of the ported text architectures
_TEXT_ARCHS = {
    "llama": (_LlamaModel, _LlamaConfig),
    "mistral": (_LlamaModel, _LlamaConfig),
    "qwen2": (_LlamaModel, _LlamaConfig),
    "qwen3": (_LlamaModel, _LlamaConfig),
}
# text architectures of the reference's fallback that the port lacks
_UNPORTED_TEXT_ARCHS = ("gemma", "gemma2")


def is_text_only_config(config: dict) -> bool:
    """The reference's rule (:88): no vision or audio config, and a model
    type of the fallback's (gemma's included, which `text_arch` refuses)."""
    return ("vision_config" not in config and "audio_config" not in config
            and config.get("model_type") in (*_TEXT_ARCHS,
                                              *_UNPORTED_TEXT_ARCHS))


def text_arch(model_type: str) -> tuple:
    """(Model, ModelConfig) of a text-only model type."""
    if model_type in _UNPORTED_TEXT_ARCHS:
        raise NotImplementedError(
            f"text-only {model_type} runs on paligemma's decoder, which is "
            f"not ported (ROADMAP Queue 1 item 7, the other model families)")
    if model_type not in _TEXT_ARCHS:
        raise ValueError(f"text_only: unsupported model type {model_type}")
    return _TEXT_ARCHS[model_type]


class ModelConfig:
    @classmethod
    def from_dict(cls, params: dict):
        return text_arch(params.get("model_type"))[1].from_dict(params)


def Model(config):
    return text_arch(config.model_type)[0](config)
