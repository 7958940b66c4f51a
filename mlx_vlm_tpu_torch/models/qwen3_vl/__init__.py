from .config import ModelConfig, TextConfig, VisionConfig
from .language import LanguageModel
from .qwen3_vl import STACK_PATTERNS, Model
from .vision import VisionModel

__all__ = ["Model", "ModelConfig", "TextConfig", "VisionConfig",
           "LanguageModel", "VisionModel", "STACK_PATTERNS"]
