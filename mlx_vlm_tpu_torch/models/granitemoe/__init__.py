from .granitemoe import Model, ModelConfig, TextConfig

__all__ = ["Model", "ModelConfig", "TextConfig"]
