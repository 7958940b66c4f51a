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


def bidirectional_prefix(model) -> bool:
    """Whether `model`'s decoder attends over the prompt without a causal
    order (PaliGemma's prefix).  Each prompt row's k/v then depends on
    every later prompt row, so that no other prompt may reuse them (prefix
    caching) and no verify of several rows may run through it
    (speculative decoding)."""
    return bool(getattr(getattr(model, "language_model", None),
                        "bidirectional", False))


def refuse_prefix_reuse(model, prefix_len: int) -> None:
    """Raise ValueError where a prompt cache holding `prefix_len` > 0 rows
    of another prompt is given to a decoder with a bidirectional prefix
    (`bidirectional_prefix`): its rows were computed while attending to
    that other prompt's later rows."""
    if prefix_len > 0 and bidirectional_prefix(model):
        raise ValueError(
            f"{model.config.model_type}: a cached prefix's rows depend on the "
            f"rest of the prompt they were computed with under its "
            f"bidirectional prefix; prefix caching is off for it")


def media_features(model, pixel_values, grid_thw, vision_cache=None):
    """The vision tower's features of one media array (an image's
    `pixel_values` or a video's `pixel_values_videos`) with its grid
    (None for LLaVA's CLIP pixels), on the model's device; its host-side
    vision inputs (`vision_aux_inputs`) go to the tower as a whole, as
    the reference passes them (generate/dispatch.py:118-140).  With a
    `vision_cache` (vision_cache.VisionFeatureCache) and a model that has
    `vision_features`, they are looked up by the array's content and
    stored there on a miss, as the reference's server does
    (mlx_vlm_tpu/server/engine.py:247-264); a model without it
    (Qwen2.5-VL) runs its tower (`tower_features`) every time, as there."""
    dev = torch.device(model.device or "cpu")
    run = getattr(model, "vision_features", None)
    key = None
    if vision_cache is not None and run is not None:
        key = vision_cache.key(pixel_values, grid_thw)
        feats = vision_cache.get(key)
        if feats is not None:
            return feats
    aux = {k: torch.from_numpy(np.asarray(v)).to(dev)
           for k, v in model.vision_aux_inputs(grid_thw).items()}
    pixels = torch.from_numpy(np.asarray(pixel_values)).to(dev)
    feats = (run or model.tower_features)(model.params, pixels, **aux)
    if key is not None:
        vision_cache.put(key, feats)
    return feats


def embed_prompt(model, inputs: dict, vision_cache=None) -> tuple:
    """prepare_inputs' arrays -> (input embeddings [1, S, D] on the model's
    device with the image's and the video's features merged in at their
    tokens (channel-packed [1, S, D * (1 + n_ds)] for a Qwen3-VL prompt
    with media), M-RoPE position ids [3, 1, S], rope deltas [1, 1]).  Each
    media array goes through the tower on its own (`media_features`, which
    takes the vision cache): the image's `pixel_values`, the video's
    `pixel_values_videos`.  The image's grid, the video's and
    `second_per_grid_ts` go to `prepare_position_ids`.  The reference
    embeds no video (ROADMAP's known faults in the reference).  An image
    processor without a grid (LLaVA's CLIP processor: pixel_values
    [B, 3, H, W] and no `image_grid_thw`) gives the family's vision inputs
    and the cache's key a grid of None, and its model's positions take
    none."""
    dev = torch.device(model.device or "cpu")
    input_ids = np.asarray(inputs["input_ids"])
    ids = torch.from_numpy(input_ids.astype(np.int64)).to(dev)
    grid_thw = video_grid = None
    if inputs.get("image_grid_thw") is not None:
        grid_thw = np.asarray(inputs["image_grid_thw"])
    feats = {}
    if inputs.get("pixel_values") is not None:
        feats["image_features"] = media_features(
            model, inputs["pixel_values"], grid_thw, vision_cache)
    if inputs.get("pixel_values_videos") is not None:
        video_grid = np.asarray(inputs["video_grid_thw"])
        feats["video_features"] = media_features(
            model, inputs["pixel_values_videos"], video_grid, vision_cache)
    embeds = model.get_input_embeddings(model.params, ids, **feats)
    kw = {}
    if inputs.get("second_per_grid_ts") is not None:
        kw["second_per_grid_ts"] = np.asarray(inputs["second_per_grid_ts"])
    position_ids, rope_deltas = model.prepare_position_ids(
        input_ids, grid_thw, video_grid, inputs.get("attention_mask"), **kw)
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
