"""Cache-capability registry for automatic prefix caching.

Port of mlx_vlm_tpu/apc_adapters.py (the registry :43-58,
register_capability :63, cache_capability :72, model_apc_mode :104): how
a model's prompt cache may be reused.

- ``"block"``: plain K/V slabs whose time axis concatenates (`KVCache`,
  `BatchKVCache`): paged into apc.py's chained-hash block pool;
- ``"exact"``: the quantized caches (int8, int4, rotated int4, the
  group-affine and TurboQuant caches): a block of codes and scale planes
  is not a clean per-token unit, so the whole prompt's cache is kept as
  one snapshot (core/cache.py `snapshot` / `restore`);
- ``None``: an object this registry does not know: APC stays out.

The registry holds class names, the reference's, with the port's names of
its classes where they differ (the reference's `_RotatedInt4` is the
port's `RotatedInt4KVCache`; the split TurboQuant cache is classed by the
dataclass rule in both).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

BLOCK = "block"
EXACT = "exact"

_REGISTRY: dict = {
    "KVCache": BLOCK,
    "BatchKVCache": BLOCK,
    # quantized planes: group boundaries and scale planes make the
    # snapshot the safe unit
    "QuantizedKVCache": EXACT,
    "Int8KVCache": EXACT,
    "Int4KVCache": EXACT,
    "RotatedInt4KVCache": EXACT,  # the reference's _RotatedInt4
    "TurboQuantKVCache": EXACT,
    # windowed rings and recurrent state (no cache of the port's model has
    # them; kept so that the registry answers as the reference's does)
    "RotatingKVCache": EXACT,
    "MixedWindowCache": EXACT,
    "ArraysCache": EXACT,
}


def register_capability(cls_or_name, capability: str) -> None:
    """Declare the APC capability of a cache class."""
    name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
    if capability not in (BLOCK, EXACT):
        raise ValueError(f"capability must be 'block' or 'exact': {capability}")
    _REGISTRY[name] = capability


def cache_capability(cache: Any) -> Optional[str]:
    """Classify one cache: an MRO walk by class name (a subclass of a
    block cache that did not register itself is demoted to "exact");
    composites take their weakest child's; an unregistered dataclass with a
    cursor `offset` is "exact"; anything else None."""
    if isinstance(cache, (tuple, list)):
        caps = [cache_capability(c) for c in cache]
        if not caps or any(c is None for c in caps):
            return None
        return BLOCK if all(c == BLOCK for c in caps) else EXACT
    for cls in type(cache).__mro__:
        cap = _REGISTRY.get(cls.__name__)
        if cap is not None:
            if cap == BLOCK and cls is not type(cache):
                return EXACT
            return cap
    if dataclasses.is_dataclass(cache) and hasattr(cache, "offset"):
        return EXACT
    return None


_MODE_CACHE: dict = {}


def model_apc_mode(model, kv_bits=None, kv_group_size: int = 64) -> Optional[str]:
    """The APC strategy for `model` under a KV-quantization policy: one
    probe cache of 256 rows made on the model's device by the factory the
    generate paths use, classified; memoized per (model type, kv_bits,
    group size, MLX_VLM_TPU_KV_SCHEME), as in the reference.  None for a
    decoder with a bidirectional prefix (PaliGemma's), where the reference
    pages its cache as any other: a prompt row's k/v there depends on the
    rest of its prompt, so that a cached prefix would carry another
    prompt's text into this one (ROADMAP, known faults in the
    reference)."""
    from .generate.common import bidirectional_prefix

    if bidirectional_prefix(model):
        return None
    key = (
        str(getattr(model, "config_dict", {}).get("model_type", "")) or
        type(model).__name__,
        None if not kv_bits else float(kv_bits),
        int(kv_group_size),
        os.environ.get("MLX_VLM_TPU_KV_SCHEME", ""),
    )
    if key in _MODE_CACHE:
        return _MODE_CACHE[key]
    import torch

    from .generate.ar import make_cache

    try:
        probe = make_cache(model, 1, 256, torch.bfloat16, kv_bits=kv_bits,
                           kv_group_size=kv_group_size,
                           device=getattr(model, "device", None) or "cpu")
        mode = cache_capability(probe)
    except Exception:  # noqa: BLE001 - a cache the factory refuses: APC off
        mode = None
    _MODE_CACHE[key] = mode
    return mode


__all__ = [
    "BLOCK",
    "EXACT",
    "register_capability",
    "cache_capability",
    "model_apc_mode",
]
