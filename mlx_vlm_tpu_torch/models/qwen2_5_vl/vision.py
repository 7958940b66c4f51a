"""Qwen2.5-VL vision tower: windowed ViT with RMSNorm and SwiGLU blocks.

Port of mlx_vlm_tpu/models/qwen2_5_vl/vision.py (window_partition_aux
:30-126, VisionModel :129-187).  The window layout (the reference's
`get_window_index`) is host numpy, computed once per image grid and copied
unchanged: a patch permutation into window order, full-attention and
window segment ids, and the inverse permutation of the merged tokens.  On
the device: the Conv3d patch embed as one matmul over flattened patches, a
gather into window order, the blocks as a Python loop over views of the
stacked weights, each attending within its full-attention segments (an
image, or a video's frame group) or its windows (`fullatt_block_indexes`)
through ops/attention.py's `segment_sdpa`, where the reference attends
all patches at once under an [N, N] segment mask; the merger, and the
inverse gather.  In window order both kinds of segment are contiguous:
windows are cut within a frame group, and a frame group's windows are
consecutive.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.layers import linear, rms_norm, swiglu_mlp
from ...core.rope import apply_rope, default_inv_freq
from ...ops.attention import segment_runs, segment_sdpa
from ..base import layer_view
from .config import VisionConfig

STACK_PREFIX = "blocks"


def window_partition_aux(grid_thw: np.ndarray, cfg: VisionConfig) -> dict:
    """Host-side window / permutation metadata (numpy):
      rotary_freqs [N, hd/2] f32 (window order),
      seg_full [N], seg_win [N] segment ids (window order),
      window_index [N_merged] merged-token permutation,
      reverse_index [N_merged] its inverse,
      patch_perm [N] the patch permutation into window order."""
    m = cfg.spatial_merge_size
    unit = m * m
    head_dim = cfg.hidden_size // cfg.num_heads
    inv_freq = default_inv_freq(head_dim // 2, 10000.0)
    vit_ws = cfg.window_size // m // cfg.patch_size

    freqs_list, seg_full_list = [], []
    window_index = []
    win_seqlens = []  # per-window merged-token counts (window order)
    widx_off = 0
    seg = 0
    for t, h, w in np.asarray(grid_thw).astype(int):
        # rotary position table (as Qwen2-VL's)
        hpos = np.repeat(np.arange(h)[:, None], w, axis=1)
        hpos = hpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.repeat(np.arange(w)[None, :], h, axis=0)
        wpos = wpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        pos = np.tile(np.stack([hpos, wpos], -1), (t, 1))
        f = pos[..., None].astype(np.float64) * inv_freq[None, None, :]
        freqs_list.append(f.reshape(pos.shape[0], -1))
        for _ in range(t):
            seg_full_list.append(np.full(h * w, seg, np.int32))
            seg += 1

        # window permutation over merged tokens
        lh, lw = h // m, w // m
        index = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h = (-lh) % vit_ws
        pad_w = (-lw) % vit_ws
        nwh, nww = (lh + pad_h) // vit_ws, (lw + pad_w) // vit_ws
        padded = np.pad(index, ((0, 0), (0, pad_h), (0, pad_w)),
                        constant_values=-100)
        padded = padded.reshape(t, nwh, vit_ws, nww, vit_ws)
        padded = padded.transpose(0, 1, 3, 2, 4).reshape(
            t, nwh * nww, vit_ws, vit_ws)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        kept = flat[flat != -100]
        window_index.append(kept + widx_off)
        win_seqlens.extend(seqlens.tolist())
        widx_off += t * lh * lw

    freqs = np.concatenate(freqs_list, 0).astype(np.float32)
    seg_full = np.concatenate(seg_full_list, 0)
    window_index = np.concatenate(window_index, 0)
    reverse_index = np.argsort(window_index)

    # window segment ids over raw patches (window order): window w owns
    # seqlens[w] * unit consecutive patches after reordering
    seg_win = np.repeat(np.arange(len(win_seqlens), dtype=np.int32),
                        np.asarray(win_seqlens) * unit)
    # rotary freqs and full segments into window order
    perm_patch = (window_index[:, None] * unit
                  + np.arange(unit)[None, :]).reshape(-1)
    freqs = freqs[perm_patch]
    seg_full = seg_full[perm_patch]
    return {
        "rotary_freqs": freqs,
        "seg_full": seg_full,
        "seg_win": seg_win,
        "window_index": window_index.astype(np.int32),
        "reverse_index": reverse_index.astype(np.int32),
        "patch_perm": perm_patch.astype(np.int32),
    }


class VisionModel:
    def __init__(self, config: VisionConfig):
        self.config = config
        if config.model_type != "qwen2_5_vl":
            raise ValueError(f"Unsupported vision model type: {config.model_type}")
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.scale = self.head_dim**-0.5
        self.merge_unit = config.spatial_merge_size**2
        self.full_blocks = frozenset(
            i for i in config.fullatt_block_indexes if i < config.depth)

    def __call__(self, params: dict, pixel_values: torch.Tensor,
                 rotary_freqs: torch.Tensor, seg_full: torch.Tensor,
                 seg_win: torch.Tensor, patch_perm: torch.Tensor,
                 reverse_index: torch.Tensor) -> torch.Tensor:
        """pixel_values [N, C*T*P*P] in the processor's patch order ->
        merged features [N / merge_unit, out_hidden_size] in that order."""
        cfg = self.config
        E = cfg.hidden_size
        w = params["patch_embed"]["proj"]["weight"]  # [E, C*T*P*P]
        h = torch.matmul(pixel_values.to(w.dtype), w.T)
        h = h[patch_perm.long()]  # window order

        cos = torch.cos(rotary_freqs)[None]
        sin = torch.sin(rotary_freqs)[None]
        runs_full = segment_runs(seg_full)
        runs_win = segment_runs(seg_win)

        blocks = params[STACK_PREFIX]
        for i in range(cfg.depth):
            lp = layer_view(blocks, i)
            runs = runs_full if i in self.full_blocks else runs_win
            x = rms_norm(lp["norm1"], h, 1e-6)
            h = h + self._attention(lp["attn"], x, cos, sin, runs)
            x = rms_norm(lp["norm2"], h, 1e-6)
            h = h + swiglu_mlp(lp["mlp"], x)

        mp = params["merger"]
        x = rms_norm(mp["ln_q"], h, 1e-6)
        x = x.reshape(-1, self.merge_unit * E)
        x = linear(mp["mlp"]["0"], x)
        x = F.gelu(x, approximate="none")
        x = linear(mp["mlp"]["2"], x)
        return x[reverse_index.long()]

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
            if "patch_embed.proj.weight" in k and v.ndim == 5:
                v = v.reshape(v.shape[0], -1)
            out[k] = v
        return out
