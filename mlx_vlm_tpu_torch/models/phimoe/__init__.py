from .phimoe import Model, ModelConfig, TextConfig

__all__ = ["Model", "ModelConfig", "TextConfig"]
