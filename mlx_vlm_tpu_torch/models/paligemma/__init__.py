from .config import ModelConfig, TextConfig, VisionConfig
from .language import LanguageModel
from .paligemma import STACK_PATTERNS, Model

__all__ = ["Model", "ModelConfig", "TextConfig", "VisionConfig",
           "LanguageModel", "STACK_PATTERNS"]
