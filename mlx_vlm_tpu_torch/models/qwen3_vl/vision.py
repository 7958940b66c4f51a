"""Qwen3-VL vision tower: ViT with interpolated learned position embeddings
and deepstack mergers.

Port of mlx_vlm_tpu/models/qwen3_vl/vision.py (pos_embed_interp_aux
:50-98, VisionModel :101-210).  The bilinear interpolation plan of the
learned [side * side, E] position table depends only on the image grid, so
it is host numpy (four source indices and weights per patch, copied
unchanged); the device does four gathers and a weighted sum in f32.  The
Conv3d patch embed is one matmul over flattened patches; the LayerNorm /
tanh-GELU blocks run as a Python loop over views of the stacked weights,
each frame (an image, or a video's frame group) attending to itself
through ops/attention.py's `segment_sdpa` (the reference: all frames in
one call under an [N, N] segment mask); after block
deepstack_visual_indexes[j] the hidden state goes through deepstack
merger j (LayerNorm after the 2x2 shuffle); the last state through the
merger (LayerNorm before it).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.layers import layer_norm, linear
from ...core.rope import apply_rope
from ...ops.attention import segment_runs, segment_sdpa
from ..base import layer_view
from ..qwen2_vl.vision import vision_rotary_and_segments
from .config import VisionConfig

STACK_PREFIX = "blocks"


def _merge_permute(x: np.ndarray, h: int, w: int, m: int) -> np.ndarray:
    """Raster order -> spatial-merge-block order (leading axis h*w)."""
    rest = x.shape[1:]
    return (x.reshape(h // m, m, w // m, m, *rest)
            .transpose(0, 2, 1, 3, *range(4, 4 + len(rest)))
            .reshape(h * w, *rest))


def pos_embed_interp_aux(grid_thw: np.ndarray, num_grid_per_side: int,
                         merge: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side bilinear interpolation plan of the learned position table:
    for each patch (merge-block order, tiled over frames) 4 source indices
    into the [side * side] table and their weights, (idx [4, N] int32,
    weights [4, N] float32)."""
    idx_all: List[np.ndarray] = []
    w_all: List[np.ndarray] = []
    side = num_grid_per_side
    for t, h, w in np.asarray(grid_thw).astype(int):
        h_idxs = np.linspace(0, side - 1, h)
        w_idxs = np.linspace(0, side - 1, w)
        hf = h_idxs.astype(np.int32)
        wf = w_idxs.astype(np.int32)
        hc = np.minimum(hf + 1, side - 1)
        wc = np.minimum(wf + 1, side - 1)
        dh = (h_idxs - hf).astype(np.float32)
        dw = (w_idxs - wf).astype(np.float32)
        idx = np.stack([
            (hf[:, None] * side + wf[None, :]),
            (hf[:, None] * side + wc[None, :]),
            (hc[:, None] * side + wf[None, :]),
            (hc[:, None] * side + wc[None, :]),
        ]).reshape(4, h * w)
        wgt = np.stack([
            (1 - dh)[:, None] * (1 - dw)[None, :],
            (1 - dh)[:, None] * dw[None, :],
            dh[:, None] * (1 - dw)[None, :],
            dh[:, None] * dw[None, :],
        ]).reshape(4, h * w)
        # to merge-block order, then tiled over frames
        idx = _merge_permute(idx.T, h, w, merge).T
        wgt = _merge_permute(wgt.T, h, w, merge).T
        idx_all.append(np.tile(idx, (1, t)))
        w_all.append(np.tile(wgt, (1, t)))
    return (np.concatenate(idx_all, axis=1).astype(np.int32),
            np.concatenate(w_all, axis=1).astype(np.float32))


class VisionModel:
    def __init__(self, config: VisionConfig):
        self.config = config
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.scale = self.head_dim**-0.5
        self.merge_unit = config.spatial_merge_size**2
        self.num_grid_per_side = int(config.num_position_embeddings**0.5)
        self.ds_indexes = tuple(config.deepstack_visual_indexes)

    def __call__(self, params: dict, pixel_values: torch.Tensor,
                 rotary_freqs: torch.Tensor, segment_ids: torch.Tensor,
                 pos_idx: torch.Tensor, pos_weights: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """pixel_values [N, C*T*P*P] -> (features [N / merge_unit, out_D],
        deepstack [n_ds, N / merge_unit, out_D] or None)."""
        cfg = self.config
        w = params["patch_embed"]["proj"]["weight"]  # [E, C*T*P*P]
        h = torch.matmul(pixel_values.to(w.dtype), w.T)
        b = params["patch_embed"]["proj"].get("bias")
        if b is not None:
            h = h + b

        table = params["pos_embed"]["weight"]  # [side * side, E]
        pos = torch.einsum("kn,knd->nd", pos_weights.float(),
                           table[pos_idx.long()].float())
        h = h + pos.to(h.dtype)

        cos = torch.cos(rotary_freqs)[None]
        sin = torch.sin(rotary_freqs)[None]
        runs = segment_runs(segment_ids)

        blocks = params[STACK_PREFIX]
        ds_feats = []
        for i in range(cfg.depth):
            lp = layer_view(blocks, i)
            x = layer_norm(lp["norm1"], h, cfg.layer_norm_eps)
            h = h + self._attention(lp["attn"], x, cos, sin, runs)
            x = layer_norm(lp["norm2"], h, cfg.layer_norm_eps)
            x = F.gelu(linear(lp["mlp"]["linear_fc1"], x), approximate="tanh")
            h = h + linear(lp["mlp"]["linear_fc2"], x)
            if i in self.ds_indexes:
                j = self.ds_indexes.index(i)
                ds_feats.append(self._merger(
                    params["deepstack_merger_list"][str(j)], h,
                    postshuffle=True))
        for j in range(len(ds_feats), len(self.ds_indexes)):
            # a level past the last block takes the last state, as the
            # reference's segmented scan does
            ds_feats.append(self._merger(
                params["deepstack_merger_list"][str(j)], h, postshuffle=True))
        out = self._merger(params["merger"], h, postshuffle=False)
        return out, (torch.stack(ds_feats) if ds_feats else None)

    def _merger(self, mp: dict, h: torch.Tensor, *,
                postshuffle: bool) -> torch.Tensor:
        E = self.config.hidden_size
        if postshuffle:
            x = layer_norm(mp["norm"], h.reshape(-1, self.merge_unit * E), 1e-6)
        else:
            x = layer_norm(mp["norm"], h, 1e-6).reshape(-1, self.merge_unit * E)
        x = F.gelu(linear(mp["linear_fc1"], x), approximate="none")
        return linear(mp["linear_fc2"], x)

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

    def aux_inputs(self, grid_thw: np.ndarray) -> dict:
        """Host-side rotary freqs, segment ids and the position table's
        interpolation plan for `grid_thw`."""
        freqs, segs = vision_rotary_and_segments(
            grid_thw, self.config.spatial_merge_size, self.head_dim)
        idx, wgt = pos_embed_interp_aux(
            grid_thw, self.num_grid_per_side, self.config.spatial_merge_size)
        return {"rotary_freqs": freqs, "segment_ids": segs, "pos_idx": idx,
                "pos_weights": wgt}

    @staticmethod
    def sanitize(weights: dict) -> dict:
        """Flatten the conv3d patch-embed weight [E, C, T, P, P] to a matmul
        weight [E, C*T*P*P]; drop position-id buffers."""
        out = {}
        for k, v in weights.items():
            if "position_ids" in k:
                continue
            if "patch_embed.proj.weight" in k and v.ndim == 5:
                v = v.reshape(v.shape[0], -1)
            out[k] = v
        return out
