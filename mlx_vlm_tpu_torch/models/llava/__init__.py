from ..clip_vision import VisionConfig
from ..llama.config import TextConfig
from .config import ModelConfig
from .llava import STACK_PATTERNS, Model

__all__ = ["Model", "ModelConfig", "TextConfig", "VisionConfig",
           "STACK_PATTERNS"]
