"""Rotary position embeddings: the default and M-RoPE cases.

Port of mlx_vlm_tpu/core/rope.py (default_inv_freq :35, rope_cos_sin :95,
apply_rope :110, mrope_section_map :159, mrope_cos_sin :183, Rope :205,
make_rope :283) for the Qwen-VL line: cos/sin are computed in f32 from
position ids, and M-RoPE picks the t/h/w position stream per frequency
through a static section map, "chunked" (Qwen2-VL, Qwen2.5-VL) or
"interleaved" (Qwen3-VL).  The scaled variants (llama3, yarn, longrope,
...) are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "default_inv_freq",
    "rope_cos_sin",
    "apply_rope",
    "mrope_section_map",
    "mrope_cos_sin",
    "Rope",
    "make_rope",
]


def default_inv_freq(dim: int, base: float = 10000.0) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions [...] int -> cos/sin [..., dim/2] f32."""
    angles = positions.float()[..., None] * inv_freq.float()[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor):
    """Half-split ("NeoX") RoPE.  q, k [B, H, S, D]; cos/sin [B, S, D/2],
    duplicated to D as in the HF convention; computed in f32."""
    cos = torch.cat([cos, cos], dim=-1)[:, None, :, :]
    sin = torch.cat([sin, sin], dim=-1)[:, None, :, :]
    dtype = q.dtype
    qf, kf = q.float(), k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(dtype), k_out.to(dtype)


def mrope_section_map(sections: Sequence[int],
                      style: str = "chunked") -> np.ndarray:
    """Frequency index -> section id (t/h/w).  "chunked": contiguous chunks
    of the given sizes (Qwen2-VL); "interleaved": index i % 3 == 1 -> h (up
    to 3 * sections[1]), i % 3 == 2 -> w (up to 3 * sections[2]), every
    other index t (Qwen3-VL)."""
    if style == "chunked":
        return np.concatenate(
            [np.full(s, i, dtype=np.int32) for i, s in enumerate(sections)])
    if style != "interleaved":
        raise ValueError(f"unknown mrope style {style}")
    n = int(sum(sections))
    out = np.zeros(n, dtype=np.int32)
    for dim, offset in enumerate((1, 2), start=1):
        out[offset:min(sections[dim] * 3, n):3] = dim
    return out


def mrope_cos_sin(position_ids: torch.Tensor, inv_freq: torch.Tensor,
                  section_map: torch.Tensor):
    """M-RoPE cos/sin [B, S, dim/2] from position ids [3, B, S]."""
    cos3, sin3 = rope_cos_sin(position_ids, inv_freq)  # [3, B, S, F]
    idx = section_map.long().view(1, 1, 1, -1).expand(1, *cos3.shape[1:])
    return cos3.gather(0, idx)[0], sin3.gather(0, idx)[0]


class Rope:
    """Host-side descriptor producing cos/sin for position ids."""

    def __init__(self, dim: int, base: float = 10000.0,
                 scaling: Optional[dict] = None, mrope_style: str = "chunked"):
        self.dim = dim
        self.section_map = None
        if scaling:
            typ = scaling.get("type") or scaling.get("rope_type") or "default"
            if typ not in ("mrope", "default"):
                raise NotImplementedError(f"rope scaling type {typ} is not ported")
            if "mrope_section" in scaling:
                self.section_map = mrope_section_map(
                    scaling["mrope_section"], mrope_style)
        self.inv_freq = np.asarray(default_inv_freq(dim, base), dtype=np.float32)
        self._on_device: dict = {}

    def _tables(self, device) -> tuple:
        """(inv_freq, section map or None) on `device`, made once per
        device: a fresh host-to-device copy on every forward would stall
        the host on each decode step and cannot be captured in a CUDA
        graph."""
        key = str(torch.device(device))
        t = self._on_device.get(key)
        if t is None:
            smap = self.section_map
            t = self._on_device[key] = (
                torch.from_numpy(self.inv_freq).to(device),
                None if smap is None else torch.from_numpy(smap).to(device))
        return t

    def cos_sin(self, position_ids: torch.Tensor):
        """position_ids: [B, S] (1-D rope) or [3, B, S] (M-RoPE)."""
        inv, smap = self._tables(position_ids.device)
        if smap is not None and position_ids.dim() == 3:
            return mrope_cos_sin(position_ids, inv, smap)
        if position_ids.dim() == 3:
            position_ids = position_ids[0]
        return rope_cos_sin(position_ids, inv)


def make_rope(dim: int, base: float, scaling: Optional[dict] = None,
              mrope_style: str = "chunked") -> Rope:
    return Rope(dim, base, scaling, mrope_style)
