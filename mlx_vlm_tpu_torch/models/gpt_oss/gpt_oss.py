"""GPT-OSS top-level model and checkpoint sanitisation.

Port of mlx_vlm_tpu/models/gpt_oss/gpt_oss.py (STACK_PATTERNS :17, Model
:20, sanitize :40-80): the llama model's interface over the GPT-OSS
language model.  Both checkpoint layouts load: HF's fused
`mlp.experts.gate_up_proj` [E, D, 2I] (gate the even columns, up the odd
ones) with its bias [E, 2I] and the transposed `down_proj` [E, I, D],
which become the decoder's [E, I, D] / [E, D, I] stacks; and the mlx
layout, whose `mlp.experts.{gate,up,down}_proj` are already split and
laid out (with `.scales` / `.biases` where quantized), kept as it is.
Arrays are numpy or torch, sliced by view and copied once.
"""

from __future__ import annotations

from ..base import contiguous
from ..llama.llama import Model as _LlamaModel
from .language import LanguageModel

STACK_PATTERNS = ("language_model.model.layers",)


class Model(_LlamaModel):
    language_model_class = LanguageModel

    @staticmethod
    def sanitize(weights: dict) -> dict:
        out = {}
        for k, v in weights.items():
            if "rotary_emb.inv_freq" in k:
                continue
            if k.endswith(".mlp.experts.gate_up_proj"):
                # [E, D, 2I] interleaved -> [E, I, D] gate / up stacks
                base = "language_model." + k[: -len("gate_up_proj")]
                out[base + "gate_proj.weight"] = contiguous(
                    v[..., ::2].swapaxes(-1, -2))
                out[base + "up_proj.weight"] = contiguous(
                    v[..., 1::2].swapaxes(-1, -2))
                continue
            if k.endswith(".mlp.experts.gate_up_proj_bias"):
                base = "language_model." + k[: -len("gate_up_proj_bias")]
                out[base + "gate_proj.bias"] = contiguous(v[..., ::2])
                out[base + "up_proj.bias"] = contiguous(v[..., 1::2])
                continue
            if k.endswith(".mlp.experts.down_proj"):
                # [E, I, D] -> [E, D, I]
                v = contiguous(v.swapaxes(-1, -2))
                k = k + ".weight"
            elif k.endswith(".mlp.experts.down_proj_bias"):
                k = k[: -len("down_proj_bias")] + "down_proj.bias"
            if not k.startswith("language_model."):
                k = "language_model." + k
            out[k] = v
        return out

    @property
    def stack_patterns(self):
        return STACK_PATTERNS
