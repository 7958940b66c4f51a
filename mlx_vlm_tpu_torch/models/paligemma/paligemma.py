"""PaliGemma / PaliGemma-2: SigLIP tower, one-linear projector, Gemma
decoder.

Port of mlx_vlm_tpu/models/paligemma/paligemma.py (Model :35,
get_input_embeddings :41-68, sanitize :80): the tower's post-normed
patches, `multi_modal_projector.linear`, the features divided by
sqrt(text hidden) (the scalar rounded to their dtype first, as the
reference does; the decoder multiplies the embeddings back by
sqrt(hidden)), and the features scattered at `image_token_index` by
`merge_input_ids_with_image_features` (the Qwen2-VL port's).  Positions
are plain sequential ones (`text_position_ids`), so `vision_aux_inputs`
is empty and an image needs no grid.

`vision_features` (the projected, scaled features of a batch of images,
[N, D]) and `get_input_embeddings(image_features=...)` let the vision
cache of `embed_prompt` and the server hold PaliGemma's features, as the
port's LLaVA does; the reference's PaliGemma has no `vision_features` and
runs its tower for every request.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.layers import linear
from ..clip_vision import ClipVisionTower
from ..llama.llama import text_position_ids
from ..qwen2_vl.qwen2_vl import merge_input_ids_with_image_features
from .config import ModelConfig
from .language import LanguageModel, scalar_in

STACK_PATTERNS = (
    "language_model.model.layers",
    "vision_tower.vision_model.encoder.layers",
)


class Model:
    def __init__(self, config: ModelConfig):
        self.config = config
        self.vision_tower = ClipVisionTower(config.vision_config)
        self.language_model = LanguageModel(config.text_config, config)
        self.params: dict = {}  # set by the loader
        self.config_dict: dict = {}
        self.device: Optional[torch.device] = None  # set by the loader

    def vision_features(self, params: dict,
                        pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B_img, C, H, W] -> projected features
        [B_img * N, D] / sqrt(text hidden), concatenated over the
        images."""
        post = self.vision_tower(params["vision_tower"],
                                 pixel_values).post_norm
        feats = linear(params["multi_modal_projector"]["linear"], post)
        feats = feats / scalar_in(self.config.text_config.hidden_size**0.5,
                                  feats.dtype)
        return feats.reshape(-1, feats.shape[-1])

    def get_input_embeddings(
        self,
        params: dict,
        input_ids: torch.Tensor,  # [B, S]
        pixel_values: Optional[torch.Tensor] = None,  # [B_img, C, H, W]
        image_features: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Token embeddings with the image features merged in at the image
        tokens."""
        embeds = self.language_model.embed(params["language_model"],
                                           input_ids)
        if pixel_values is None and image_features is None:
            return embeds
        if image_features is None:
            image_features = self.vision_features(params, pixel_values)
        return merge_input_ids_with_image_features(
            self.config.image_token_index, -1, image_features, embeds,
            input_ids)

    def __call__(self, params: dict, inputs_embeds: torch.Tensor, cache,
                 position_ids: torch.Tensor) -> torch.Tensor:
        """Forward over embeddings -> logits [B, S, V] (cache written in
        place)."""
        return self.language_model.step_logits(
            params["language_model"], inputs_embeds, cache, position_ids)

    def prepare_position_ids(self, input_ids: np.ndarray,
                             image_grid_thw=None, video_grid_thw=None,
                             attention_mask=None):
        return text_position_ids(input_ids, attention_mask)

    def vision_aux_inputs(self, grid_thw) -> dict:
        return {}

    @staticmethod
    def sanitize(weights: dict) -> dict:
        out = {k: v for k, v in weights.items()
               if "self_attn.rotary_emb.inv_freq" not in k}
        vt = ClipVisionTower.sanitize(
            {k: v for k, v in out.items() if k.startswith("vision_tower.")})
        out = {k: v for k, v in out.items()
               if not k.startswith("vision_tower.")}
        out.update(vt)
        return out

    @property
    def stack_patterns(self):
        return STACK_PATTERNS

    @property
    def decoder_layers(self) -> int:
        return self.config.text_config.num_hidden_layers
