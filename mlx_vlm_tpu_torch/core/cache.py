"""KV cache: fixed-capacity buffers written by index.

Port of mlx_vlm_tpu/core/cache.py (_flash_eligible :47, KVCache :79,
init_cache :149, update_layer :169).  The cache holds every layer's K and V
in two preallocated buffers [L, B, n_kv_heads, capacity, head_dim]; rows
share one write cursor `offset` and mask their unused prefix with
`left_pad`.  Unlike the reference's immutable arrays, writes happen IN
PLACE at `offset`: `update_layer` and `KVCache.attend` mutate the buffers
they are given, and `advance` moves the cursor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["KVCache", "init_cache", "update_layer", "flash_eligible"]


def flash_eligible(q: torch.Tensor, k_buf: torch.Tensor) -> bool:
    """Route a prefill chunk to the flash-attention kernel (K4).

    The reference's rule with "tensor is on CUDA" in place of its TPU check:
    S >= 256 query rows, capacity C >= 8192 and a multiple of 128.  A dtype
    or head size the kernel does not take makes `flash_attention` raise; it
    is not rerouted to `sdpa`."""
    if q.device.type != "cuda":
        return False
    S, C = q.shape[2], k_buf.shape[2]
    return S >= 256 and C >= 8192 and C % 128 == 0


def update_layer(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, offset: int):
    """Write S new tokens at `offset` into one layer's [B, H, C, D] buffers,
    in place.  Raises if the write does not fit (no silent clamping)."""
    S = k_new.shape[2]
    C = k_cache.shape[2]
    if offset < 0 or offset + S > C:
        raise ValueError(f"cache write [{offset}, {offset + S}) exceeds capacity {C}")
    k_cache[:, :, offset:offset + S] = k_new.to(k_cache.dtype)
    v_cache[:, :, offset:offset + S] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


@dataclasses.dataclass
class KVCache:
    """All-layer KV cache.

    k, v:     [L, B, n_kv_heads, capacity, head_dim]
    offset:   tokens written so far (host int, the shared write cursor)
    left_pad: int32 [B] on the cache's device
    """

    k: torch.Tensor
    v: torch.Tensor
    offset: int
    left_pad: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    def advance(self, new_tokens: int) -> None:
        self.offset += new_tokens

    def attend(self, layer: int, q, k, v, scale: float, mask) -> torch.Tensor:
        """Write this layer's new k/v at `offset` (in place) and attend.

        Prefill chunks that pass `flash_eligible` go through the flash
        kernel; decode and other shapes use `sdpa` with `mask`."""
        from ..ops.attention import sdpa

        k_buf, v_buf = self.k[layer], self.v[layer]
        update_layer(k_buf, v_buf, k, v, self.offset)
        if flash_eligible(q, k_buf):
            from ..ops.flash_attention import flash_attention

            B = q.shape[0]
            off = torch.full((B,), self.offset, dtype=torch.int32,
                             device=q.device)
            return flash_attention(q, k_buf, v_buf, off, self.left_pad, scale)
        return sdpa(q, k_buf, v_buf, scale, mask)


def init_cache(num_layers: int, batch_size: int, num_kv_heads: int,
               head_dim: int, capacity: int, dtype=torch.bfloat16,
               left_pad: Optional[torch.Tensor] = None,
               device=None) -> KVCache:
    shape = (num_layers, batch_size, num_kv_heads, capacity, head_dim)
    if left_pad is None:
        left_pad = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        offset=0,
        left_pad=left_pad.to(device=device, dtype=torch.int32),
    )
