"""Qwen2.5-VL top-level model.

Port of mlx_vlm_tpu/models/qwen2_5_vl/qwen2_5_vl.py (Model :24,
get_input_embeddings :30, prepare_position_ids :72, vision_aux_inputs :79,
sanitize :82).  The language model is Qwen2-VL's (`qwen2_vl.language.
LanguageModel`, whose fused decode step K3 serves this family too).  The
reference gives this family no `vision_features`, so the server's vision
cache does not apply to it (generate/common.py `embed_prompt` checks);
`tower_features` runs the tower for `embed_prompt` all the same.  A video
merges as Qwen2-VL's does (`merge_media_features`), and its frame groups'
time positions step by second_per_grid_ts * tokens_per_second, as
transformers' get_rope_index steps them, where the reference steps them
by one (ROADMAP's known faults in the reference).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..qwen2_vl.language import LanguageModel, mrope_position_ids
from ..qwen2_vl.qwen2_vl import merge_media_features
from .config import ModelConfig
from .vision import VisionModel, window_partition_aux

STACK_PATTERNS = ("language_model.model.layers", "vision_tower.blocks")


class Model:
    def __init__(self, config: ModelConfig):
        self.config = config
        self.vision_tower = VisionModel(config.vision_config)
        self.language_model = LanguageModel(config.text_config, config)
        self.params: dict = {}  # set by the loader
        self.config_dict: dict = {}
        self.device: Optional[torch.device] = None  # set by the loader

    def get_input_embeddings(
        self,
        params: dict,
        input_ids: torch.Tensor,  # [B, S]
        pixel_values: Optional[torch.Tensor] = None,  # [N, C*T*P*P]
        rotary_freqs: Optional[torch.Tensor] = None,
        seg_full: Optional[torch.Tensor] = None,
        seg_win: Optional[torch.Tensor] = None,
        patch_perm: Optional[torch.Tensor] = None,
        reverse_index: Optional[torch.Tensor] = None,
        window_index: Optional[torch.Tensor] = None,  # metadata; unused
        image_features: Optional[torch.Tensor] = None,
        video_features: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Token embeddings with the image features merged in at the image
        tokens and the video features at the video tokens."""
        embeds = self.language_model.embed(params["language_model"], input_ids)
        feats = image_features
        if feats is None and pixel_values is not None:
            feats = self.tower_features(params, pixel_values, rotary_freqs,
                                        seg_full, seg_win, patch_perm,
                                        reverse_index)
        return merge_media_features(
            self.config.image_token_id, self.config.video_token_id, feats,
            video_features, embeds, input_ids)

    def tower_features(self, params: dict, pixel_values: torch.Tensor,
                       rotary_freqs: torch.Tensor, seg_full: torch.Tensor,
                       seg_win: torch.Tensor, patch_perm: torch.Tensor,
                       reverse_index: torch.Tensor,
                       window_index: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Merged vision features [N_merged, D] of an image or a video."""
        return self.vision_tower(params["vision_tower"], pixel_values,
                                 rotary_freqs, seg_full, seg_win, patch_perm,
                                 reverse_index)

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
        """M-RoPE ids; a video's time by `second_per_grid_ts` (one per
        video; 1.0 each when None, as transformers takes it) times the
        vision config's tokens_per_second."""
        cfg = self.config
        if video_grid_thw is not None and second_per_grid_ts is None:
            second_per_grid_ts = np.ones(len(video_grid_thw), np.float32)
        return mrope_position_ids(
            input_ids, image_grid_thw, video_grid_thw, attention_mask,
            merge=cfg.vision_config.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
            second_per_grid_ts=second_per_grid_ts,
            tokens_per_second=cfg.vision_config.tokens_per_second)

    def vision_aux_inputs(self, grid_thw: np.ndarray) -> dict:
        """Host-side window layout and rotary freqs for the vision tower."""
        return window_partition_aux(grid_thw, self.config.vision_config)

    @staticmethod
    def sanitize(weights: dict) -> dict:
        """HF checkpoint key remap (as Qwen2-VL's)."""

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
