from .olmoe import Model, ModelConfig, TextConfig

__all__ = ["Model", "ModelConfig", "TextConfig"]
