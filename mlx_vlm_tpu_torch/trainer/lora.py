"""LoRA / DoRA adapters at inference: attach, fuse, save, load.

Port of the inference half of mlx_vlm_tpu/trainer/lora.py (attach_lora
:98, fuse_lora :140, fuse_dora :160, save_adapter :192, load_adapter :206,
apply_lora_layers :217); `init_lora`, `init_dora` and the train steps wait
for the trainer's port.  An adapter is a dict {path: {"lora_a": [.., r,
in], "lora_b": [.., out, r], "dora_m"?: [.., out]}}, the path naming a
linear's dict in the model's parameter tree ("language_model.model.layers
.self_attn.q_proj", stacked over the layers); `core/layers.py` `linear`
adds it to the base product.  The files are the reference's:
adapters.safetensors (f32, keys "<path>.<kind>") and adapter_config.json,
read and written without the `safetensors` package.

A model that carries adapter factors does not take the fused decode step
(K3): its kernel reads the base weights alone, so the adapter would be
invisible to the step while the prefill sees it.  `apply_lora_layers`
decides the route again, and `ops/fused_decode.py`'s eligibility refuses
such a tree and logs it; the reference keeps its pack and decodes without
the adapter (ROADMAP Queue 3, known faults).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.layers import dense_weight

__all__ = ["attach_lora", "fuse_lora", "fuse_dora", "save_adapter",
           "load_adapter", "apply_lora_layers", "has_adapters"]

ADAPTER_KEYS = ("lora_a", "lora_b", "dora_m")


def _walk(tree: dict, adapters: dict, visit, prefix: str = "") -> dict:
    """A shallow copy of `tree` whose dicts named in `adapters` are
    replaced by visit(dict, factors)."""
    new = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            v = _walk(v, adapters, visit, path)
            if path in adapters:
                v = visit(v, adapters[path])
        new[k] = v
    return new


def attach_lora(params: dict, lora: dict) -> dict:
    """The tree with each adapter's factors inserted beside its weight
    (shallow copies; the weights are shared)."""
    return _walk(params, lora, lambda v, fac: {**v, **fac})


def fuse_lora(params: dict, lora: dict) -> dict:
    """The tree with each LoRA folded into its dense weight: W + B A, in
    the weight's dtype.  A quantized weight raises, as the reference's sum
    does."""

    def fold(v, fac):
        w = v["weight"]
        if not isinstance(w, torch.Tensor):
            raise TypeError(f"fuse_lora: a {type(w).__name__} weight takes "
                            f"no fused LoRA")
        delta = torch.einsum("...or,...ri->...oi", fac["lora_b"],
                             fac["lora_a"])
        return {**v, "weight": w + delta.to(w.dtype)}

    return _walk(params, lora, fold)


def fuse_dora(params: dict, dora: dict) -> dict:
    """The tree with each DoRA folded into its weight: (m / ||W + B A||)
    (W + B A) per output row, in f32, stored in the weight's dtype (a
    quantized weight becomes dense, in its own dtype)."""

    def fold(v, fac):
        w = dense_weight(v["weight"])
        delta = torch.einsum("...or,...ri->...oi", fac["lora_b"].float(),
                             fac["lora_a"].float())
        adapted = w.float() + delta
        norm = torch.sqrt(adapted.square().sum(dim=-1) + 1e-12)
        scaled = adapted * (fac["dora_m"].float() / norm)[..., None]
        return {**v, "weight": scaled.to(w.dtype)}

    return _walk(params, dora, fold)


def has_adapters(tree) -> bool:
    """Whether any dict of the tree carries adapter factors."""
    if not isinstance(tree, dict):
        return False
    return any(k in tree for k in ADAPTER_KEYS) or any(
        has_adapters(v) for v in tree.values())


def save_adapter(path: str, lora: dict, config: Optional[dict] = None):
    """adapters.safetensors (every factor in f32) and adapter_config.json
    under `path`."""
    from ..utils.loader import write_safetensors

    os.makedirs(path, exist_ok=True)
    flat = {f"{p}.{kind}": torch.as_tensor(leaf).detach().to(
        "cpu", torch.float32).numpy() for p, fac in lora.items()
        for kind, leaf in fac.items()}
    write_safetensors(os.path.join(path, "adapters.safetensors"), flat)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump(config or {}, f)


def load_adapter(path: str, dtype=torch.float32, device="cpu") -> dict:
    """The adapter under `path` (its adapters.safetensors), every factor in
    `dtype` on `device`."""
    from ..utils.loader import read_safetensors

    lora: dict = {}
    flat = read_safetensors(os.path.join(path, "adapters.safetensors"))
    for k, v in flat.items():
        base, kind = k.rsplit(".", 1)
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        lora.setdefault(base, {})[kind] = t.to(device, dtype)
    return lora


def apply_lora_layers(model, adapter_path: str):
    """Attach the adapter under `adapter_path` to the model's parameters
    (f32 factors on the model's device, as the reference keeps them) and
    decide the fused decode route again (off with an adapter)."""
    from ..utils.loader import decide_fused_decode

    lora = load_adapter(adapter_path, device=model.device or "cpu")
    model.params = attach_lora(model.params, lora)
    decide_fused_decode(model)
    return model
