"""Shared generation types and helpers.

Port of mlx_vlm_tpu/generate/common.py (round_up :16, GenerationResult :30),
and `embed_prompt`, the step from a prompt's arrays to the language model's
inputs that stream_generate and batch_generate share.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def device_peak_memory_gb(device) -> float:
    """Peak memory allocated by torch on a CUDA device, in GiB (0.0 on CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / (1024**3)


def embed_prompt(model, inputs: dict, vision_cache=None) -> tuple:
    """prepare_inputs' arrays -> (input embeddings [1, S, D] on the model's
    device with any image merged by the vision tower (channel-packed
    [1, S, D * (1 + n_ds)] for a Qwen3-VL image prompt), M-RoPE position
    ids [3, 1, S], rope deltas [1, 1]).  The family's host-side vision
    inputs (`vision_aux_inputs`) go to the tower as a whole, as the
    reference passes them (generate/dispatch.py:118-140).  With a
    `vision_cache` (vision_cache.VisionFeatureCache) and a model that has
    `vision_features`, the tower's output is looked up by the image's
    content and stored there on a miss, as the reference's server does
    (mlx_vlm_tpu/server/engine.py:247-264); a model without it (Qwen2.5-VL)
    runs its tower every time, as there.  An image processor without a
    grid (LLaVA's CLIP processor: pixel_values [B, 3, H, W] and no
    `image_grid_thw`) gives the family's vision inputs and the cache's key
    a grid of None, and its model's positions take none."""
    dev = torch.device(model.device or "cpu")
    input_ids = np.asarray(inputs["input_ids"])
    ids = torch.from_numpy(input_ids.astype(np.int64)).to(dev)
    pixel_values = inputs.get("pixel_values")
    grid_thw = None
    if pixel_values is None:
        embeds = model.get_input_embeddings(model.params, ids)
    else:
        if inputs.get("image_grid_thw") is not None:
            grid_thw = np.asarray(inputs["image_grid_thw"])
        aux = {k: torch.from_numpy(np.asarray(v)).to(dev)
               for k, v in model.vision_aux_inputs(grid_thw).items()}
        pixels = torch.from_numpy(np.asarray(pixel_values)).to(dev)
        if vision_cache is None or not hasattr(model, "vision_features"):
            embeds = model.get_input_embeddings(model.params, ids, pixels,
                                                **aux)
        else:
            key = vision_cache.key(pixel_values, grid_thw)
            feats = vision_cache.get(key)
            if feats is None:
                feats = model.vision_features(model.params, pixels, **aux)
                vision_cache.put(key, feats)
            embeds = model.get_input_embeddings(model.params, ids,
                                                image_features=feats)
    position_ids, rope_deltas = model.prepare_position_ids(
        input_ids, grid_thw, None, inputs.get("attention_mask"))
    return embeds, position_ids, rope_deltas


@dataclasses.dataclass
class GenerationResult:
    """Per-chunk streaming result."""

    text: str
    token: Optional[int]
    logprobs: Any
    prompt_tokens: int
    generation_tokens: int
    prompt_tps: float
    generation_tps: float
    peak_memory: float
    finish_reason: Optional[str] = None
    total_tokens: int = 0

    def __post_init__(self):
        self.total_tokens = self.prompt_tokens + self.generation_tokens
