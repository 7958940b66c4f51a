from .ar import generate_step
from .batch import (BatchGenerator, BatchRequest, BatchResponse,
                    SamplingParams, batch_generate)
from .common import GenerationResult
from .dispatch import generate, stream_generate

__all__ = ["generate", "stream_generate", "generate_step", "batch_generate",
           "BatchGenerator", "BatchRequest", "BatchResponse",
           "SamplingParams", "GenerationResult"]
