"""Model hot-swap registry: serve several models from one process.

Port of mlx_vlm_tpu/server/registry.py (ModelRegistry :34): named models
load on first request through the port's `load` (onto the card) and are
LRU-evicted past `max_models`.  Each entry owns its ResponseGenerator (a
single-owner engine thread with its own continuous-batching slots);
device memory is the scarce resource, so eviction shuts the generator
down and drops the model before the next one loads.

The server does not use it yet (server/app.py refuses extra models): it
loads a model on the calling handler thread and starts a second owner
thread, so either could make CUDA calls while the first owner captures
its decode step, which a capture in the "global" error mode refuses.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Dict, Optional

logger = logging.getLogger("mlx_vlm_tpu_torch.server.registry")


class ModelEntry:
    def __init__(self, name: str, model, processor, generator):
        self.name = name
        self.model = model
        self.processor = processor
        self.generator = generator


class ModelRegistry:
    """name -> live ModelEntry with load-on-demand + LRU eviction."""

    def __init__(self, max_models: int = 2, **engine_kwargs):
        self._paths: Dict[str, str] = {}
        self._live: "OrderedDict[str, ModelEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.max_models = max_models
        self.engine_kwargs = engine_kwargs

    # ------------------------------------------------------------- admin
    def register(self, name: str, path: Optional[str] = None,
                 entry: Optional[ModelEntry] = None):
        """Register by checkpoint path (lazy) or with live objects."""
        with self._lock:
            if entry is not None:
                self._live[name] = entry
                self._live.move_to_end(name)
            if path is not None:
                self._paths[name] = path

    def names(self):
        with self._lock:
            return sorted(set(self._paths) | set(self._live))

    def unload(self, name: str) -> bool:
        with self._lock:
            entry = self._live.pop(name, None)
        if entry is None:
            return False
        self._shutdown(entry)
        return True

    # ------------------------------------------------------------- lookup
    def get(self, name: Optional[str]) -> Optional[ModelEntry]:
        """Live entry for `name`, loading from its registered path if
        needed; None if unknown.  A None/empty name returns the most
        recently used entry (single-model compatibility)."""
        with self._lock:
            if not name:
                if self._live:
                    return next(reversed(list(self._live.values())))
                return None
            if name in self._live:
                self._live.move_to_end(name)
                return self._live[name]
            path = self._paths.get(name)
        if path is None:
            return None
        return self._load(name, path)

    def _load(self, name: str, path: str) -> ModelEntry:
        from ..utils.loader import load
        from .engine import ResponseGenerator

        logger.info("loading model %r from %s", name, path)
        evicted = []
        with self._lock:
            while len(self._live) >= self.max_models:
                _, old = self._live.popitem(last=False)
                evicted.append(old)
        for old in evicted:
            self._shutdown(old)
        model, processor = load(path)
        generator = ResponseGenerator(model, processor, **self.engine_kwargs)
        entry = ModelEntry(name, model, processor, generator)
        with self._lock:
            self._live[name] = entry
            self._live.move_to_end(name)
        return entry

    @staticmethod
    def _shutdown(entry: ModelEntry):
        logger.info("evicting model %r", entry.name)
        try:
            entry.generator.shutdown()
        except Exception:  # noqa: BLE001
            logger.exception("generator shutdown failed")
        entry.model = None  # drop the model and its parameters

    def shutdown(self):
        with self._lock:
            entries = list(self._live.values())
            self._live.clear()
        for e in entries:
            self._shutdown(e)
