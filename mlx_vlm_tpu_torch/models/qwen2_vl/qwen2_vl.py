"""Qwen2-VL top-level model.

Port of mlx_vlm_tpu/models/qwen2_vl/qwen2_vl.py (Model :50,
merge_input_ids_with_image_features :29, sanitize :137,
prepare_position_ids :113, vision_aux_inputs :124).  The feature merge is a
vectorized masked gather (cumsum + index + where).

A video's features (the tower over its frame groups, `vision_features`
with the video's grid) merge at the video token and an image's at the
image token, each stream in its own token order (`merge_media_features`).
The reference merges one stream, its image features then its video
features, at both tokens in token order (:29-45): the two agree where all
images come before all videos; where a video precedes an image, or a
prompt holds video tokens and no video, the reference puts another
media's features (or a clamped row) at those tokens.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import ModelConfig
from .language import LanguageModel
from .vision import VisionModel, vision_rotary_and_segments

# prefixes whose per-index submodules are stacked at load time
STACK_PATTERNS = ("language_model.model.layers", "vision_tower.blocks")


def merge_input_ids_with_image_features(
    image_token_id: int,
    video_token_id: int,
    image_features: torch.Tensor,  # [N_feat, D], concatenated across rows
    inputs_embeds: torch.Tensor,  # [B, S, D]
    input_ids: torch.Tensor,  # [B, S]
) -> torch.Tensor:
    """Scatter vision features into the embeddings at vision tokens: the
    k-th vision token in row-major order takes feature k."""
    B, S, D = inputs_embeds.shape
    flat_ids = input_ids.reshape(-1)
    is_img = (flat_ids == image_token_id) | (flat_ids == video_token_id)
    feat_idx = torch.cumsum(is_img.to(torch.int64), dim=0) - 1
    feat_idx = feat_idx.clamp(0, image_features.shape[0] - 1)
    gathered = image_features[feat_idx]  # [B*S, D]
    merged = torch.where(is_img[:, None], gathered.to(inputs_embeds.dtype),
                         inputs_embeds.reshape(-1, D))
    return merged.reshape(B, S, D)


def merge_media_features(image_token_id: int, video_token_id: int,
                         image_features: Optional[torch.Tensor],
                         video_features: Optional[torch.Tensor],
                         inputs_embeds: torch.Tensor,
                         input_ids: torch.Tensor) -> torch.Tensor:
    """Image features [N_img, D] at the image tokens and video features
    [N_vid, D] at the video tokens, each in token order; a stream that is
    None leaves its tokens' embeddings as they are."""
    out = inputs_embeds
    for tok, feats in ((image_token_id, image_features),
                       (video_token_id, video_features)):
        if feats is not None:
            out = merge_input_ids_with_image_features(tok, tok, feats, out,
                                                      input_ids)
    return out


class Model:
    def __init__(self, config: ModelConfig):
        self.config = config
        self.vision_tower = VisionModel(config.vision_config)
        self.language_model = LanguageModel(config.text_config, config)
        self.params: dict = {}  # set by the loader
        self.config_dict: dict = {}
        self.device: Optional[torch.device] = None  # set by the loader

    def vision_features(self, params: dict, pixel_values: torch.Tensor,
                        rotary_freqs: torch.Tensor,
                        segment_ids: torch.Tensor) -> torch.Tensor:
        """Merged vision features [N_merged, D]."""
        return self.vision_tower(params["vision_tower"], pixel_values,
                                 rotary_freqs, segment_ids)

    def get_input_embeddings(
        self,
        params: dict,
        input_ids: torch.Tensor,  # [B, S]
        pixel_values: Optional[torch.Tensor] = None,  # [N, C*T*P*P]
        rotary_freqs: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        image_features: Optional[torch.Tensor] = None,
        video_features: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Token embeddings with the image features merged in at the image
        tokens and the video features at the video tokens."""
        embeds = self.language_model.embed(params["language_model"], input_ids)
        feats = image_features
        if feats is None and pixel_values is not None:
            feats = self.vision_features(params, pixel_values, rotary_freqs,
                                         segment_ids)
        return merge_media_features(
            self.config.image_token_id, self.config.video_token_id, feats,
            video_features, embeds, input_ids)

    def __call__(self, params: dict, inputs_embeds: torch.Tensor, cache,
                 position_ids: torch.Tensor) -> torch.Tensor:
        """Forward over embeddings -> logits [B, S, V] (cache written in place;
        a B=1, S=1 step takes the fused route when it is on)."""
        return self.language_model.step_logits(
            params["language_model"], inputs_embeds, cache, position_ids)

    def prepare_position_ids(self, input_ids: np.ndarray,
                             image_grid_thw: Optional[np.ndarray] = None,
                             video_grid_thw: Optional[np.ndarray] = None,
                             attention_mask: Optional[np.ndarray] = None,
                             second_per_grid_ts=None):
        """M-RoPE ids over both grids (`second_per_grid_ts` is Qwen2.5-VL's;
        this family steps a video's time by one a frame group)."""
        return self.language_model.get_rope_index(
            input_ids, image_grid_thw, video_grid_thw, attention_mask)

    def vision_aux_inputs(self, grid_thw: np.ndarray) -> dict:
        """Host-side rotary freqs and segment ids for the vision tower."""
        freqs, segs = vision_rotary_and_segments(
            grid_thw, self.config.vision_config.spatial_merge_size,
            self.vision_tower.head_dim)
        return {"rotary_freqs": freqs, "segment_ids": segs}

    @staticmethod
    def sanitize(weights: dict) -> dict:
        """HF checkpoint key remap (reference qwen2_vl.py:179-190)."""

        def transform(key: str) -> str:
            if "vision_tower" not in key:
                key = key.replace("visual", "vision_tower")
            if "language_model" not in key:
                if key.startswith("model."):
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
