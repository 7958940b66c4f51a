"""Qwen3-VL top-level model.

Port of mlx_vlm_tpu/models/qwen3_vl/qwen3_vl.py (Model :29,
vision_features :35, get_input_embeddings :42-80, prepare_position_ids
:88, vision_aux_inputs :94, sanitize :98-116).  The vision tower returns
(features, deepstack [n_ds, N, D]); both are scattered at the visual
tokens and channel-packed into one [B, S, D * (1 + n_ds)] array, zeros at
text positions so that the in-layer add is a no-op there (language.py).

`get_input_embeddings(image_features=...)` takes `vision_features`' pair
as it is, so that a vision-cache hit keeps the deepstack features.  The
reference takes the pair as plain features (:56-57) and cannot merge it
(ROADMAP's known faults in the reference).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..qwen2_vl.qwen2_vl import merge_media_features
from .config import ModelConfig
from .language import LanguageModel
from .vision import VisionModel

STACK_PATTERNS = ("language_model.model.layers", "vision_tower.blocks")


def _pair(features):
    """vision_features' (features, deepstack) pair, features alone or None
    -> (features or None, deepstack or None)."""
    if isinstance(features, tuple):
        return features
    return features, None


class Model:
    def __init__(self, config: ModelConfig):
        self.config = config
        self.vision_tower = VisionModel(config.vision_config)
        self.language_model = LanguageModel(config.text_config, config)
        self.params: dict = {}  # set by the loader
        self.config_dict: dict = {}
        self.device: Optional[torch.device] = None  # set by the loader

    def vision_features(self, params: dict, pixel_values: torch.Tensor,
                        rotary_freqs: torch.Tensor, segment_ids: torch.Tensor,
                        pos_idx: torch.Tensor, pos_weights: torch.Tensor):
        """(merged features [N_merged, D], deepstack [n_ds, N_merged, D] or
        None)."""
        return self.vision_tower(params["vision_tower"], pixel_values,
                                 rotary_freqs, segment_ids, pos_idx,
                                 pos_weights)

    def get_input_embeddings(
        self,
        params: dict,
        input_ids: torch.Tensor,  # [B, S]
        pixel_values: Optional[torch.Tensor] = None,  # [N, C*T*P*P]
        rotary_freqs: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        pos_idx: Optional[torch.Tensor] = None,
        pos_weights: Optional[torch.Tensor] = None,
        image_features=None,  # vision_features' pair, or features alone
        video_features=None,  # the same for a video
    ) -> torch.Tensor:
        """Token embeddings with the image features merged in at the image
        tokens and the video features at the video tokens; with deepstack
        features, channel-packed [B, S, D * (1 + n_ds)]."""
        embeds = self.language_model.embed(params["language_model"], input_ids)
        if image_features is None and pixel_values is not None:
            image_features = self.vision_features(
                params, pixel_values, rotary_freqs, segment_ids, pos_idx,
                pos_weights)
        img, img_ds = _pair(image_features)
        vid, vid_ds = _pair(video_features)
        ids = (self.config.image_token_id, self.config.video_token_id)
        merged = merge_media_features(*ids, img, vid, embeds, input_ids)
        levels = next((d.shape[0] for d in (img_ds, vid_ds) if d is not None),
                      0)
        if not levels:
            return merged
        zeros = torch.zeros_like(embeds)
        packed = [merged] + [
            merge_media_features(*ids, None if img_ds is None else img_ds[i],
                                 None if vid_ds is None else vid_ds[i], zeros,
                                 input_ids)
            for i in range(levels)]
        return torch.cat(packed, dim=-1)

    def __call__(self, params: dict, inputs_embeds: torch.Tensor, cache,
                 position_ids: torch.Tensor) -> torch.Tensor:
        """Forward over embeddings -> logits [B, S, V] (cache written in
        place)."""
        return self.language_model.step_logits(
            params["language_model"], inputs_embeds, cache, position_ids)

    def prepare_position_ids(self, input_ids: np.ndarray,
                             image_grid_thw: Optional[np.ndarray] = None,
                             video_grid_thw: Optional[np.ndarray] = None,
                             attention_mask: Optional[np.ndarray] = None,
                             second_per_grid_ts=None):
        """M-RoPE ids (`second_per_grid_ts` is Qwen2.5-VL's; this family
        writes a video's times into the prompt as text)."""
        return self.language_model.get_rope_index(
            input_ids, image_grid_thw, video_grid_thw, attention_mask)

    def vision_aux_inputs(self, grid_thw: np.ndarray) -> dict:
        return self.vision_tower.aux_inputs(grid_thw)

    @staticmethod
    def sanitize(weights: dict) -> dict:
        """Key remap of both layouts: HF (model.visual.*,
        model.language_model.*, lm_head) and the mlx conversions' (visual.*,
        model.*)."""

        def transform(key: str) -> str:
            key = key.replace("model.visual.", "vision_tower.")
            key = key.replace("model.language_model.", "language_model.model.")
            if key.startswith("visual."):
                key = "vision_tower." + key[len("visual."):]
            if key.startswith("model.") and not key.startswith("model.language"):
                key = "language_model." + key
            elif key.startswith("lm_head"):
                key = "language_model." + key
            return key

        weights = {transform(k): v for k, v in weights.items()}
        vt = {k: v for k, v in weights.items() if k.startswith("vision_tower.")}
        vt = VisionModel.sanitize(vt)
        weights = {k: v for k, v in weights.items()
                   if not k.startswith("vision_tower.")}
        weights.update(vt)
        return weights

    @property
    def stack_patterns(self):
        return STACK_PATTERNS

    @property
    def decoder_layers(self) -> int:
        return self.config.text_config.num_hidden_layers
