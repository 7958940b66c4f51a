"""CLIP / SigLIP vision encoder (LLaVA's and PaliGemma's tower).

Port of mlx_vlm_tpu/models/clip_vision.py (VisionConfig :37, _act :53,
patchify_images :63, ClipVisionTower :74, sanitize :145).  The Conv2d
patch embedding (stride = kernel) is one matmul over flattened patches;
CLIP adds its class embedding, the positions and `pre_layrnorm`, SigLIP
the positions alone; the encoder runs as a Python loop over views of the
stacked layers and keeps every layer's hidden state, so that
`vision_feature_layer` picks one by index.  Attention goes through
ops/attention.py's `sdpa`, as the reference's tower does.  CLIP's
activation defaults to quick-GELU, SigLIP's to tanh GELU; CLIP pools its
class token, SigLIP the mean of the post-normed patches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.config import BaseModelConfig
from ..core.layers import layer_norm, linear
from ..ops.attention import sdpa
from .base import layer_view

STACK_PREFIX = "vision_model.encoder.layers"


class TowerOutput(NamedTuple):
    pooled: torch.Tensor
    last_hidden: torch.Tensor  # before post_layernorm
    hidden_states: torch.Tensor  # [L + 1, B, N, D]
    post_norm: torch.Tensor  # post_layernorm(last_hidden)


@dataclass
class VisionConfig(BaseModelConfig):
    model_type: str = "clip_vision_model"
    num_hidden_layers: int = 24
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    projection_dim: int = 768
    vocab_size: int = 32000
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: Optional[str] = None  # default by model_type


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu_pytorch_tanh", "gelu_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"unknown activation {name}")


def patchify_images(pixel_values: torch.Tensor,
                    patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, gh * gw, C * P * P] in torch-conv flatten
    order."""
    B, C, H, W = pixel_values.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = pixel_values.reshape(B, C, gh, P, gw, P)
    x = x.permute(0, 2, 4, 1, 3, 5)  # B, gh, gw, C, P, P
    return x.reshape(B, gh * gw, C * P * P)


class ClipVisionTower:
    """Functional CLIP / SigLIP tower over params keyed as HF
    `vision_model.*`."""

    def __init__(self, config: VisionConfig):
        self.config = config
        if config.model_type not in ("clip_vision_model",
                                     "siglip_vision_model"):
            raise ValueError(
                f"Unsupported vision model type: {config.model_type}")
        self.is_clip = config.model_type == "clip_vision_model"
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.scale = self.head_dim**-0.5
        self.act = _act(config.hidden_act or (
            "quick_gelu" if self.is_clip else "gelu_pytorch_tanh"))

    def __call__(self, params: dict,
                 pixel_values: torch.Tensor) -> TowerOutput:
        """pixel_values [B, C, H, W] -> TowerOutput(pooled, last_hidden,
        hidden_states [L + 1, B, N, D], post_norm)."""
        cfg = self.config
        eps = cfg.layer_norm_eps
        vm = params["vision_model"]
        emb = vm["embeddings"]
        w = emb["patch_embedding"]["weight"]  # [E, C * P * P]
        x = torch.matmul(patchify_images(pixel_values, cfg.patch_size)
                         .to(w.dtype), w.T)
        if "bias" in emb["patch_embedding"]:
            x = x + emb["patch_embedding"]["bias"]
        if self.is_clip:
            cls = emb["class_embedding"].to(x.dtype).expand(
                x.shape[0], 1, cfg.hidden_size)
            x = torch.cat([cls, x], dim=1)
        x = x + emb["position_embedding"]["weight"][None, :x.shape[1]]
        if self.is_clip and "pre_layrnorm" in vm:
            x = layer_norm(vm["pre_layrnorm"], x, eps)
        states = [x]
        layers = vm["encoder"]["layers"]
        for i in range(cfg.num_hidden_layers):
            lp = layer_view(layers, i)
            y = layer_norm(lp["layer_norm1"], x, eps)
            x = x + self._attention(lp["self_attn"], y)
            y = layer_norm(lp["layer_norm2"], x, eps)
            x = x + linear(lp["mlp"]["fc2"],
                           self.act(linear(lp["mlp"]["fc1"], y)))
            states.append(x)
        post = layer_norm(vm["post_layernorm"], x, eps)
        pooled = post[:, 0] if self.is_clip else post.mean(dim=1)
        return TowerOutput(pooled, x, torch.stack(states), post)

    def _attention(self, p, x):
        B, N, D = x.shape
        q, k, v = (linear(p[n], x).reshape(B, N, self.num_heads,
                                           self.head_dim).transpose(1, 2)
                   for n in ("q_proj", "k_proj", "v_proj"))
        out = sdpa(q, k, v, self.scale, None)
        return linear(p["out_proj"], out.transpose(1, 2).reshape(B, N, D))

    @staticmethod
    def sanitize(weights: dict) -> dict:
        """Drop position ids; flatten the conv2d patch weight [E, C, P, P]
        to [E, C * P * P]."""
        out = {}
        for k, v in weights.items():
            if "position_ids" in k:
                continue
            if "patch_embedding.weight" in k and v.ndim == 4:
                v = v.reshape(v.shape[0], -1)
            out[k] = v
        return out
