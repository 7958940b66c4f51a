"""Qwen2-VL vision tower: ViT with 2-D rotary embeddings and patch merger.

Port of mlx_vlm_tpu/models/qwen2_vl/vision.py.  The Conv3d patch embed has
stride == kernel, so it is a matmul over flattened (C*T*P*P) patches;
each segment (an image, or a video's frame group) attends to itself
through ops/attention.py's `segment_sdpa`, where the reference attends all
patches in one call under an [N, N] segment mask (a 64-frame 448 x 448
video's f32 scores would take 68.7 GB there); the stacked blocks run as a
Python loop over per-block views; 2-D rotary frequencies and segment ids
come from `grid_thw` on the host (numpy).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.layers import gelu_mlp, layer_norm, linear
from ...core.rope import apply_rope, default_inv_freq
from ...ops.attention import segment_runs, segment_sdpa
from ..base import layer_view
from .config import VisionConfig

STACK_PREFIX = "blocks"


def vision_rotary_and_segments(grid_thw: np.ndarray, spatial_merge_size: int,
                               head_dim: int):
    """Per-patch 2-D rotary freqs [N, head_dim/2] f32 and segment ids [N]
    int32 (one segment per image frame), from grid_thw."""
    inv_freq = default_inv_freq(head_dim // 2, 10000.0)
    freqs_list = []
    seg_list = []
    seg = 0
    m = spatial_merge_size
    for t, h, w in np.asarray(grid_thw).astype(int):
        hpos = np.repeat(np.arange(h)[:, None], w, axis=1)
        hpos = hpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.repeat(np.arange(w)[None, :], h, axis=0)
        wpos = wpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        pos = np.stack([hpos, wpos], axis=-1)
        pos = np.tile(pos, (t, 1))
        f = pos[..., None].astype(np.float64) * inv_freq[None, None, :]
        freqs_list.append(f.reshape(pos.shape[0], -1))
        for _ in range(t):
            seg_list.append(np.full(h * w, seg, np.int32))
            seg += 1
    freqs = np.concatenate(freqs_list, axis=0).astype(np.float32)
    segs = np.concatenate(seg_list, axis=0)
    return freqs, segs


class VisionModel:
    def __init__(self, config: VisionConfig):
        self.config = config
        if config.model_type not in ("qwen2_vl",):
            raise ValueError(f"Unsupported vision model type: {config.model_type}")
        self.num_heads = config.num_heads
        self.head_dim = config.embed_dim // config.num_heads
        self.scale = self.head_dim**-0.5
        self.merge_unit = config.spatial_merge_size**2

    def __call__(self, params: dict, pixel_values: torch.Tensor,
                 rotary_freqs: torch.Tensor,
                 segment_ids: torch.Tensor) -> torch.Tensor:
        """pixel_values [N, C*T*P*P] -> merged features [N / merge_unit, D]."""
        cfg = self.config
        E = cfg.embed_dim
        w = params["patch_embed"]["proj"]["weight"]  # [E, C*T*P*P]
        h = torch.matmul(pixel_values.to(w.dtype), w.T)

        cos = torch.cos(rotary_freqs)[None]  # [1, N, head_dim/2]
        sin = torch.sin(rotary_freqs)[None]
        runs = segment_runs(segment_ids)

        blocks = params[STACK_PREFIX]
        for i in range(cfg.depth):
            lp = layer_view(blocks, i)
            x = layer_norm(lp["norm1"], h, cfg.layer_norm_eps)
            h = h + self._attention(lp["attn"], x, cos, sin, runs)
            x = layer_norm(lp["norm2"], h, cfg.layer_norm_eps)
            h = h + gelu_mlp(lp["mlp"], x, approximate=True)

        mp = params["merger"]
        x = layer_norm(mp["ln_q"], h, 1e-6)
        x = x.reshape(-1, self.merge_unit * E)
        x = linear(mp["mlp"]["0"], x)
        x = F.gelu(x, approximate="none")
        return linear(mp["mlp"]["2"], x)

    def _attention(self, p, x, cos, sin, runs):
        N = x.shape[0]
        qkv = linear(p["qkv"], x).reshape(N, 3, self.num_heads, self.head_dim)
        q = qkv[:, 0].transpose(0, 1)[None]  # [1, heads, N, hd]
        k = qkv[:, 1].transpose(0, 1)[None]
        v = qkv[:, 2].transpose(0, 1)[None]
        q, k = apply_rope(q, k, cos, sin)
        out = segment_sdpa(q, k, v, self.scale, runs)
        out = out[0].transpose(0, 1).reshape(N, -1)
        return linear(p["proj"], out)

    @staticmethod
    def sanitize(weights: dict) -> dict:
        """Flatten the conv3d patch-embed weight [E, C, T, P, P] to a matmul
        weight [E, C*T*P*P]; drop position-id buffers."""
        out = {}
        for k, v in weights.items():
            if "position_ids" in k:
                continue
            if "patch_embed.proj.weight" in k:
                if v.ndim == 5:
                    v = v.reshape(v.shape[0], -1)
                elif v.ndim != 2:
                    raise ValueError(f"unexpected patch_embed weight shape {v.shape}")
            out[k] = v
        return out
