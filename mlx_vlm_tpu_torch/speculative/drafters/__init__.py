"""Drafter registry and checkpoint loading for the target-coupled drafters.

Port of mlx_vlm_tpu/speculative/drafters/__init__.py
(DRAFTER_KIND_BY_MODEL_TYPE :25, resolve_drafter_kind :40,
validate_drafter_compatibility :58, load_drafter :94).  A drafter
checkpoint is a directory with config.json (its model_type selects the
kind) and safetensors, read by the port's own reader (utils/loader.py
`read_safetensors`: no `safetensors` package).  EAGLE-3 and MTP drafters
that omit embed_tokens / lm_head are bound to the target (`bind`): they
take the target's rows through its `embed` and its head through its
`logits`, whatever the target's layout (the reference copies the target's
parameter dicts in, and reads the table's `weight`); DFlash always
borrows both at draft time.  Parameters land on `device`, the card unless
the caller passes another.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

from .dflash import DFlashConfig, DFlashDrafter, stack_trees
from .eagle3 import Eagle3Config, Eagle3Drafter
from .mtp import MTPConfig, MTPDrafter

__all__ = [
    "DRAFTER_KIND_BY_MODEL_TYPE", "resolve_drafter_kind", "load_drafter",
    "validate_drafter_compatibility", "Eagle3Drafter", "Eagle3Config",
    "MTPDrafter", "MTPConfig", "DFlashDrafter", "DFlashConfig",
]

DRAFTER_KIND_BY_MODEL_TYPE = {
    "deepseek_v4_mtp": "mtp",
    "eagle3": "eagle3",
    "gemma4_assistant": "mtp",
    "gemma4_unified_assistant": "mtp",
    "glm4_moe_lite_mtp": "mtp",
    "inkling_mtp": "mtp",
    "qwen3_5_mtp": "mtp",
    "qwen3_dflash": "dflash",
    "qwen3_5_dflash": "dflash",
}


def resolve_drafter_kind(model_type: str) -> str:
    """model_type -> drafter kind; plain LMs draft as they are
    ("vanilla")."""
    kind = DRAFTER_KIND_BY_MODEL_TYPE.get(model_type)
    if kind is not None:
        return kind
    low = str(model_type).lower()
    if "dflash" in low:
        return "dflash"
    if "mtp" in low:
        return "mtp"
    return "vanilla"


_CFG_FIELDS = (
    "hidden_size", "intermediate_size", "num_attention_heads",
    "num_key_value_heads", "vocab_size", "rms_norm_eps", "rope_theta",
)


def validate_drafter_compatibility(target_model, config: dict,
                                   kind: str) -> None:
    """Config-field compatibility (reference :58): the drafter's hidden
    size must be the target's, and an MTP drafter's vocabulary too."""
    tgt_cfg = getattr(target_model, "config", None)
    tc = getattr(tgt_cfg, "text_config", tgt_cfg)
    target_hidden = getattr(tc, "hidden_size", None)
    draft_hidden = (config.get("backbone_hidden_size")
                    or config.get("target_hidden_size")
                    or config.get("hidden_size"))
    if (target_hidden is not None and draft_hidden is not None
            and target_hidden != draft_hidden):
        raise ValueError(
            f"drafter hidden_size={draft_hidden} does not match the target's "
            f"hidden_size={target_hidden}")
    vocab = config.get("vocab_size")
    tgt_vocab = getattr(tc, "vocab_size", None)
    if kind == "mtp" and vocab and tgt_vocab and vocab != tgt_vocab:
        raise ValueError(f"MTP drafter vocab {vocab} != target vocab "
                         f"{tgt_vocab}")


def load_drafter(path, target_model, dtype=torch.float32,
                 kind: Optional[str] = None,
                 device="cuda") -> Tuple[Any, dict, str]:
    """Load (drafter, params, kind) from a checkpoint directory, the
    parameters in `dtype` on `device` (the card unless the caller says
    otherwise).  Missing embed_tokens / lm_head are the target's (`bind`,
    the reference's bind(), drafters/deepseek_v4_mtp:95)."""
    from ...utils.loader import _as_tensor, _nest, read_safetensors

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the drafter loads onto the GPU "
                           "unless the caller passes device='cpu'")
    path = Path(path)
    config = json.loads((path / "config.json").read_text())
    model_type = config.get("model_type", "")
    if kind is None:
        kind = DRAFTER_KIND_BY_MODEL_TYPE.get(model_type)
        if kind is None and "dflash" in model_type.lower():
            kind = "dflash"
        if kind is None and "mtp" in model_type.lower():
            kind = "mtp"
        if kind is None:
            raise ValueError(f"unknown drafter model_type {model_type!r}")
    validate_drafter_compatibility(target_model, config, kind)

    fields = {k: config[k] for k in _CFG_FIELDS if k in config}
    if kind == "eagle3":
        cap = tuple(config.get("capture_layers", (1, 2, 3)))
        drafter = Eagle3Drafter(Eagle3Config(capture_layers=cap, **fields))
    elif kind == "mtp":
        drafter = MTPDrafter(MTPConfig(**fields))
    elif kind == "dflash":
        dcfg = config.get("dflash_config", {}) or {}
        drafter = DFlashDrafter(DFlashConfig(
            **fields,
            num_hidden_layers=config.get("num_hidden_layers", 5),
            head_dim=config.get("head_dim"),
            mask_token_id=int(dcfg.get("mask_token_id",
                                       config.get("mask_token_id", 0))),
            block_size=int(dcfg.get("runtime_block_size")
                           or config.get("block_size", 16)),
            target_layer_ids=tuple(dcfg.get(
                "target_layer_ids",
                config.get("target_layer_ids", (1, 8, 15, 22, 29)))),
            target_hidden_size=config.get("target_hidden_size"),
        ))
    else:
        raise ValueError(f"unsupported drafter kind {kind!r}")

    flat: dict = {}
    for f in sorted(path.glob("*.safetensors")):
        for k, v in read_safetensors(f).items():
            t = _as_tensor(v)
            t = t.to(device, dtype) if t.is_floating_point() else t.to(device)
            flat[k.replace("model.", "", 1) if k.startswith("model.")
                 else k] = t
    params = _nest(flat)
    if kind == "dflash" and isinstance(params.get("layers"), dict):
        # layers.0 .. layers.N-1 stacked on a leading axis
        idx = sorted(params["layers"], key=int)
        params["layers"] = stack_trees([params["layers"][i] for i in idx])
    if kind != "dflash" and ("embed_tokens" not in params
                             or "lm_head" not in params):
        drafter.bind(target_model.language_model,
                     target_model.params["language_model"])
    return drafter, params, kind
