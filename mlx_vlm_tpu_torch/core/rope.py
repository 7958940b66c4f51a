"""Rotary position embeddings: the default, scaled and M-RoPE cases.

Port of mlx_vlm_tpu/core/rope.py (default_inv_freq :35, llama3_inv_freq
:41, yarn_inv_freq :62, rope_cos_sin :95, apply_rope :110,
mrope_section_map :159, mrope_cos_sin :183, Rope :205, make_rope :283):
cos/sin are computed in f32 from position ids; M-RoPE picks the t/h/w
position stream per frequency through a static section map, "chunked"
(Qwen2-VL, Qwen2.5-VL) or "interleaved" (Qwen3-VL).  The scaled variants
of `Rope` (llama3, yarn with its attention scaling, linear, longrope / su,
proportional) remap the inverse frequencies on the host once, in float64
as the reference does; the tables then live on each device (`_tables`),
so a captured decode step reads no host data.  A head dim wider than the
rotated one (partial rotary) passes its tail lanes through `apply_rope`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "default_inv_freq",
    "llama3_inv_freq",
    "yarn_inv_freq",
    "rope_cos_sin",
    "apply_rope",
    "mrope_section_map",
    "mrope_cos_sin",
    "Rope",
    "make_rope",
]


def default_inv_freq(dim: int, base: float = 10000.0) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


def llama3_inv_freq(dim: int, base: float, scaling: dict) -> np.ndarray:
    """Llama-3 frequency remapping (reference :41): wavelengths past the
    original context's low-frequency bound divided by `factor`, those
    under its high-frequency bound kept, the ones between smoothed."""
    factor = scaling["factor"]
    low_freq_factor = scaling.get("low_freq_factor", 1.0)
    high_freq_factor = scaling.get("high_freq_factor", 4.0)
    old_ctx = scaling.get("original_max_position_embeddings", 8192)

    inv = default_inv_freq(dim, base)
    wavelens = 2 * math.pi / inv
    low_wl = old_ctx / low_freq_factor
    high_wl = old_ctx / high_freq_factor

    inv_scaled = np.where(wavelens > low_wl, inv / factor, inv)
    smooth = (old_ctx / wavelens - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smoothed = inv * ((1 - smooth) / factor + smooth)
    is_medium = (wavelens > high_wl) & (wavelens < low_wl)
    return np.where(is_medium, smoothed, inv_scaled)


def yarn_inv_freq(dim: int, base: float, scaling: dict) -> tuple:
    """YaRN (reference :62): (inv_freq, the attention scaling that
    multiplies cos and sin).  The correction range's ends are rounded
    (floor of the low end, ceil of the high end) only when
    scaling["truncate"] is true or absent, as transformers does
    (`_compute_yarn_parameters`); the reference always rounds, which
    moves gpt-oss's range (its config sets `truncate: false`) from
    8.09-17.40 to 8-18 (ROADMAP Queue 3, divergences)."""
    factor = scaling.get("factor", 1.0)
    orig_max = scaling.get("original_max_position_embeddings", 4096)
    beta_fast = scaling.get("beta_fast", 32.0)
    beta_slow = scaling.get("beta_slow", 1.0)
    mscale_all_dim = scaling.get("mscale_all_dim", 0.0)
    mscale = scaling.get("mscale", 1.0)

    def find_dim(num_rot):
        return (dim * math.log(orig_max / (num_rot * 2 * math.pi))) / (
            2 * math.log(base))

    low, high = find_dim(beta_fast), find_dim(beta_slow)
    if scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)

    inv_extra = default_inv_freq(dim, base) / factor
    inv_inter = default_inv_freq(dim, base)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low)
                   / max(high - low, 0.001), 0, 1)
    inv = inv_inter * (1 - ramp) + inv_extra * ramp

    def get_mscale(scale, m=1.0):
        if scale <= 1:
            return 1.0
        return 0.1 * m * math.log(scale) + 1.0

    att_scale = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
    return inv, att_scale


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 attention_scaling: float = 1.0):
    """positions [...] int -> cos/sin [..., dim/2] f32, each times
    `attention_scaling` (YaRN's and longrope's mscale; 1 otherwise)."""
    angles = positions.float()[..., None] * inv_freq.float()[None, :]
    if attention_scaling == 1.0:
        return torch.cos(angles), torch.sin(angles)
    return (torch.cos(angles) * attention_scaling,
            torch.sin(angles) * attention_scaling)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor):
    """Half-split ("NeoX") RoPE.  q, k [B, H, S, D]; cos/sin [B, S, D/2],
    duplicated to D as in the HF convention; computed in f32.  When cos
    covers fewer than D/2 angle slots (partial rotary), only the first
    2 * slots lanes rotate and the tail passes through."""
    rot = 2 * cos.shape[-1]
    if rot < q.shape[-1]:
        q_r, k_r = apply_rope(q[..., :rot], k[..., :rot], cos, sin)
        return (torch.cat([q_r, q[..., rot:]], dim=-1),
                torch.cat([k_r, k[..., rot:]], dim=-1))
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
                  section_map: torch.Tensor, attention_scaling: float = 1.0):
    """M-RoPE cos/sin [B, S, dim/2] from position ids [3, B, S]."""
    cos3, sin3 = rope_cos_sin(position_ids, inv_freq,
                              attention_scaling)  # [3, B, S, F]
    idx = section_map.long().view(1, 1, 1, -1).expand(1, *cos3.shape[1:])
    return cos3.gather(0, idx)[0], sin3.gather(0, idx)[0]


class Rope:
    """Host-side descriptor producing cos/sin for position ids."""

    def __init__(self, dim: int, base: float = 10000.0,
                 scaling: Optional[dict] = None,
                 max_position_embeddings: int = 131072,
                 mrope_style: str = "chunked"):
        self.dim = dim
        self.attention_scaling = 1.0
        self.section_map = None
        inv = default_inv_freq(dim, base)
        if scaling:
            typ = scaling.get("type") or scaling.get("rope_type") or "default"
            if typ == "llama3":
                inv = llama3_inv_freq(dim, base, scaling)
            elif typ == "yarn":
                inv, self.attention_scaling = yarn_inv_freq(dim, base,
                                                            scaling)
            elif typ == "linear":
                inv = inv / scaling.get("factor", 1.0)
            elif typ in ("longrope", "su"):
                # phi3's per-dim factors (the long ones always apply) and
                # mscale: an explicit long_mscale wins over the derived one
                inv = inv / np.asarray(scaling.get("long_factor", 1.0),
                                       np.float64)
                orig = scaling.get("original_max_position_embeddings", 4096)
                mscale = scaling.get("long_mscale")
                if mscale:
                    self.attention_scaling = float(mscale)
                elif max_position_embeddings / orig > 1.0:
                    s = max_position_embeddings / orig
                    self.attention_scaling = float(
                        np.sqrt(1.0 + np.log(s) / np.log(orig)))
            elif typ == "proportional":
                # the first partial_rotary_factor share of angle slots
                # rotates at frequency / factor, the rest not at all
                factor = float(scaling.get("factor", 1.0))
                partial = float(scaling.get("partial_rotary_factor", 1.0))
                angles = int(partial * dim // 2)
                expo = np.arange(0, 2 * angles, 2, np.float64) / dim
                inv = np.concatenate([1.0 / (factor * np.power(base, expo)),
                                      np.zeros(dim // 2 - angles)])
            elif typ in ("mrope", "default"):
                if "mrope_section" in scaling:
                    self.section_map = mrope_section_map(
                        scaling["mrope_section"], mrope_style)
            else:
                raise ValueError(f"unsupported rope scaling type: {typ}")
        self.inv_freq = np.asarray(inv, dtype=np.float32)
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
            return mrope_cos_sin(position_ids, inv, smap,
                                 self.attention_scaling)
        if position_ids.dim() == 3:
            position_ids = position_ids[0]
        return rope_cos_sin(position_ids, inv, self.attention_scaling)


def make_rope(dim: int, base: float, scaling: Optional[dict] = None,
              max_position_embeddings: int = 131072,
              mrope_style: str = "chunked") -> Rope:
    return Rope(dim, base, scaling, max_position_embeddings, mrope_style)
