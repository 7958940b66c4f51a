from .config import ModelConfig, TextConfig, VisionConfig
from .qwen2_5_vl import STACK_PATTERNS, Model
from .vision import VisionModel

__all__ = ["Model", "ModelConfig", "TextConfig", "VisionConfig",
           "VisionModel", "STACK_PATTERNS"]
