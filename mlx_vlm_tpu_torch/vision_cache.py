"""LRU cache of projected vision features.

Port of mlx_vlm_tpu/vision_cache.py (VisionFeatureCache :20): keyed by a
sha256 over every byte of the `pixel_values` array, its shape and the
grid, default 20 entries.  The reference hashes the first 256 KiB of the
array only, so two images or clips that open alike (a screenshot's header
bar, a video's first frames) share its key (ROADMAP's known faults in the
reference); on an array within those 256 KiB the two keys are equal.
The stores of images and of videos (generate/common.py `embed_prompt`)
are keyed each by its own array.  The server's engine stores the vision
tower's merged features here as tensors on the model's device
(server/engine.py `_prepare`).
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from typing import Any, Optional

import numpy as np

DEFAULT_SIZE = int(os.environ.get("MLX_VLM_VISION_CACHE_SIZE", "20"))


class VisionFeatureCache:
    def __init__(self, max_size: int = DEFAULT_SIZE):
        self.max_size = max_size
        self._store: "OrderedDict[str, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(pixel_values, grid_thw=None) -> str:
        h = hashlib.sha256()
        arr = np.asarray(pixel_values)
        h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        h.update(str(arr.shape).encode())
        if grid_thw is not None:
            h.update(np.asarray(grid_thw).tobytes())
        return h.hexdigest()

    def get(self, key: str):
        feats = self._store.get(key)
        if feats is not None:
            self._store.move_to_end(key)
            self.hits += 1
        else:
            self.misses += 1
        return feats

    def put(self, key: str, feats):
        self._store[key] = feats
        self._store.move_to_end(key)
        while len(self._store) > self.max_size:
            self._store.popitem(last=False)

    def clear(self):
        self._store.clear()
