from .config import ModelConfig, TextConfig
from .gpt_oss import STACK_PATTERNS, Model
from .language import LanguageModel

__all__ = ["Model", "ModelConfig", "TextConfig", "LanguageModel",
           "STACK_PATTERNS"]
