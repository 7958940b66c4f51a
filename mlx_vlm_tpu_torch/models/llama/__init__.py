from .config import ModelConfig, TextConfig
from .language import LanguageModel
from .llama import STACK_PATTERNS, Model

__all__ = ["Model", "ModelConfig", "TextConfig", "LanguageModel",
           "STACK_PATTERNS"]
