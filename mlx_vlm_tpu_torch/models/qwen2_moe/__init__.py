from .config import ModelConfig, TextConfig
from .language import MoELanguageModel
from .qwen2_moe import STACK_PATTERNS, Model

__all__ = ["Model", "ModelConfig", "TextConfig", "MoELanguageModel",
           "STACK_PATTERNS"]
