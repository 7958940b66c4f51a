from .mixtral import Model, ModelConfig, TextConfig

__all__ = ["Model", "ModelConfig", "TextConfig"]
