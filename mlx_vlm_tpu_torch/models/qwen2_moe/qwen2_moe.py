"""Qwen-MoE top-level (text) model.

Port of mlx_vlm_tpu/models/qwen2_moe/qwen2_moe.py (STACK_PATTERNS :9,
Model :16, sanitize :37): the llama model's interface over the MoE
language model.  HF checkpoints keep one key per expert
(`mlp.experts.{e}.{gate,up,down}_proj.weight`), which the loader stacks
on axis 1 into [L, E, ...] (`STACK_PATTERNS`); mlx conversions keep each
layer's experts stacked (`mlp.switch_mlp.{gate,up,down}_proj`, [E, I, D] /
[E, D, I], with `.scales` and `.biases` where quantized), which `sanitize`
renames to the same keys.  The reference's `sanitize` renames neither,
so it loads the HF layout only (ROADMAP Queue 3).

`rename_key` is the renaming that `sanitize` applies to a key; the loader
applies it to the quantization config's per-path entries as well, so that
an entry under the checkpoint's name (an 8-bit router) finds its weight.
The derived families (mixtral, olmoe, phimoe, granitemoe) set their own
`RENAMES`.
"""

from __future__ import annotations

from ..llama.llama import Model as _LlamaModel
from .language import MoELanguageModel

STACK_PATTERNS = (
    "language_model.model.layers",
    # per-layer expert stacks land on axis 1 -> [L, E, ...]
    ("language_model.model.layers.mlp.experts", 1),
)


class Model(_LlamaModel):
    language_model_class = MoELanguageModel
    # (checkpoint substring, the decoder's) pairs, applied in order
    RENAMES: tuple = ((".mlp.switch_mlp.", ".mlp.experts."),)

    @classmethod
    def rename_key(cls, key: str) -> str:
        for old, new in cls.RENAMES:
            key = key.replace(old, new)
        return key

    @classmethod
    def sanitize(cls, weights: dict) -> dict:
        out = {}
        for k, v in weights.items():
            if "rotary_emb.inv_freq" in k:
                continue
            k = cls.rename_key(k)
            if not k.startswith("language_model."):
                k = "language_model." + k
            out[k] = v
        return out

    @property
    def stack_patterns(self):
        return STACK_PATTERNS
