"""Config dataclass substrate.

Port of mlx_vlm_tpu/core/config.py: `from_dict` drops unknown keys so an HF
`config.json` can be poured into a per-architecture dataclass.
"""

from __future__ import annotations

import dataclasses
import inspect
from dataclasses import dataclass


@dataclass
class BaseModelConfig:
    @classmethod
    def from_dict(cls, params: dict):
        """Build the config from a dict, silently dropping unknown keys."""
        allowed = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in params.items() if k in allowed})

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if dataclasses.is_dataclass(v):
                v = v.to_dict() if hasattr(v, "to_dict") else dataclasses.asdict(v)
            out[f.name] = v
        return out
