"""Shared model substrate.

Counterpart of mlx_vlm_tpu/models/base.py and of the scan helpers in
mlx_vlm_tpu/core/quant_scan.py: the reference runs stacked layers under
`lax.scan`; the port loops over the layers in Python, handing each
iteration views of the stacked weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quant import (ChannelQuantizedTensor, Int4GroupedTensor,
                          QuantizedTensor)


def layer_view(tree: dict, i: int) -> dict:
    """Layer `i` of a stacked parameter tree, as views (no copies)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = layer_view(v, i)
        elif isinstance(v, (Int4GroupedTensor, QuantizedTensor,
                            ChannelQuantizedTensor)):
            out[k] = v.layer(i)
        elif isinstance(v, torch.Tensor):
            out[k] = v[i]
        else:
            raise NotImplementedError(
                f"stacked parameter {k} of type {type(v).__name__}")
    return out


def contiguous(v):
    """A checkpoint array (numpy, or a torch tensor for bf16 data) laid out
    contiguously, as the loader's stacking and upload take it."""
    if isinstance(v, torch.Tensor):
        return v.contiguous()
    return np.ascontiguousarray(v)
