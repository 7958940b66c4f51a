from .config import ModelConfig, TextConfig, VisionConfig
from .language import MoELanguageModel
from .qwen3_vl_moe import Model

__all__ = ["Model", "ModelConfig", "TextConfig", "VisionConfig",
           "MoELanguageModel"]
