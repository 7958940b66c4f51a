"""Qwen3-VL-MoE top-level model.

Port of mlx_vlm_tpu/models/qwen3_vl_moe/qwen3_vl_moe.py (Model :89, sanitize
:95-123): Qwen3-VL's model (its deepstack tower, the (features, deepstack)
pair of the vision cache, the channel-packed embeddings) over the MoE
language model.  `sanitize` normalises both fused expert layouts to the
stacked [E, I, D] / [E, D, I] one: the HF layout (`experts.gate_up_proj`
[E, D, 2I], `experts.down_proj` [E, I, D], dense) and the mlx conversions'
(`switch_mlp.{gate,up,down}_proj` [E, I, D] / [E, D, I], with `.scales` and
`.biases` where quantized).
"""

from __future__ import annotations

import torch

from ..qwen3_vl.qwen3_vl import Model as _VLModel
from .config import ModelConfig
from .language import MoELanguageModel


def _swap_last(v):
    """[E, a, b] -> [E, b, a], contiguous, for a numpy array or a tensor."""
    if isinstance(v, torch.Tensor):
        return v.permute(0, 2, 1).contiguous()
    return v.transpose(0, 2, 1).copy()


class Model(_VLModel):
    def __init__(self, config: ModelConfig):
        super().__init__(config)
        self.language_model = MoELanguageModel(config.text_config, config)

    @staticmethod
    def sanitize(weights: dict) -> dict:
        weights = _VLModel.sanitize(weights)
        out = {}
        for k, v in weights.items():
            if ".mlp.switch_mlp." in k:
                # mlx fused layout: already [E, I, D] / [E, D, I]
                k = k.replace(".switch_mlp.", ".experts.")
                if k.endswith("_proj"):
                    k += ".weight"
                out[k] = v
                continue
            if ".mlp.experts." in k:
                if k.endswith("gate_up_proj"):
                    # HF fused layout [E, D, 2I] -> gate / up [E, I, D]
                    half = v.shape[-1] // 2
                    base = k[: -len("gate_up_proj")]
                    out[base + "gate_proj.weight"] = _swap_last(v[..., :half])
                    out[base + "up_proj.weight"] = _swap_last(v[..., half:])
                    continue
                if k.endswith("experts.down_proj"):
                    # HF fused layout [E, I, D] -> [E, D, I]
                    out[k + ".weight"] = _swap_last(v)
                    continue
            out[k] = v
        return out
