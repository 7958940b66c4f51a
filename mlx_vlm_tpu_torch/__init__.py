"""mlx_vlm_tpu_torch — the PyTorch / CUDA port of mlx_vlm_tpu.

The JAX package `mlx_vlm_tpu` is the reference; module paths here mirror it
(this file: mlx_vlm_tpu/__init__.py).
It runs the Qwen2-VL, Qwen2.5-VL and Qwen3-VL families (the loader picks
the model by its config's model_type) with 4-bit group-64 weights (the
halves-packed grouped-int4 layout for the first two, per-channel int8 or
the mlx codes for Qwen3-VL) end to end: load -> chat template -> inputs -> vision
tower -> M-RoPE -> chunked prefill -> decode, with a bf16 KV cache or a
quantized one (`kv_bits` 8, 4 or 3.5), one request at a time
(`generate`, `stream_generate`) or several in fixed batch slots
(`batch_generate`, `BatchGenerator`: continuous batching on per-row cache
cursors, `kv_bits` 8 or 4), speculatively with a smaller draft model
(`draft_model=`, speculative/), and behind the HTTP server
(`python -m mlx_vlm_tpu_torch server`: the OpenAI, Anthropic and
Responses routes, structured outputs, tool calls; mlx_vlm_tpu_torch/server).
Its kernels are CUDA C++ written for Hopper
(mlx_vlm_tpu_torch/csrc), built with nvcc at first use.
Importing the package needs neither JAX nor transformers, PIL,
safetensors, tokenizers or triton.
"""

from .generate import GenerationResult, generate, generate_step, stream_generate
from .generate.batch import (BatchGenerator, BatchRequest, SamplingParams,
                             batch_generate)
from .prompt_utils import apply_chat_template
from .utils.loader import load, load_config, load_model
from .utils.processing import prepare_inputs

__all__ = [
    "load",
    "load_model",
    "load_config",
    "generate",
    "stream_generate",
    "generate_step",
    "batch_generate",
    "BatchGenerator",
    "BatchRequest",
    "SamplingParams",
    "GenerationResult",
    "apply_chat_template",
    "prepare_inputs",
]
