from .ar import generate_step
from .common import GenerationResult
from .dispatch import generate, stream_generate

__all__ = ["generate", "stream_generate", "generate_step", "GenerationResult"]
