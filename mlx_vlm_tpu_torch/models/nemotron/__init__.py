"""Nemotron: LayerNorm1P (weight + 1), a relu^2 up / down MLP and a
partial rotary with linear scaling.

Port of mlx_vlm_tpu/models/nemotron/__init__.py (ModelConfig :13,
sanitize :44) on models/classic_base.py.  Every key of a module is
renamed, the `.scales` / `.biases` of an mlx-quantized embedding table
too, where the reference renames the table's `weight` alone (ROADMAP
Queue 3, known faults).
"""

from __future__ import annotations

import re

from ..classic_base import ClassicConfig, ClassicLanguageModel, ClassicModel


class ModelConfig(ClassicConfig):
    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        scale = 1.0
        rs = d.get("rope_scaling")
        if rs and rs.get("type") == "linear":
            scale = 1.0 / float(rs["factor"])
        return cls(
            model_type="nemotron",
            hidden_size=d.get("hidden_size", 4096),
            num_hidden_layers=d.get("num_hidden_layers", 32),
            num_attention_heads=d.get("num_attention_heads", 32),
            num_key_value_heads=d.get("num_key_value_heads"),
            head_dim=d.get("head_dim"),
            intermediate_size=d.get("intermediate_size"),
            vocab_size=d.get("vocab_size", 256000),
            layer_norm_eps=d.get("norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            rope_pct=d.get("partial_rotary_factor", 0.5),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scale=scale,
            norm="layer1p",
            parallel=False,
            act="relu2",
        )


LanguageModel = ClassicLanguageModel


class Model(ClassicModel):
    def sanitize(self, weights: dict) -> dict:
        out = {}
        for k, v in weights.items():
            if "rotary_emb" in k:
                continue
            k = re.sub(r"^model\.layers\.(\d+)\.",
                       r"language_model.model.layers.\1.", k)
            k = k.replace(".input_layernorm.", ".ln1.")
            k = k.replace(".post_attention_layernorm.", ".ln2.")
            k = k.replace(".self_attn.", ".attn.")
            if k.startswith("model.embed_tokens."):
                k = ("language_model.model.wte."
                     + k[len("model.embed_tokens."):])
            elif k.startswith("model.norm."):
                k = "language_model.model.ln_f." + k[len("model.norm."):]
            elif k.startswith("lm_head."):
                k = "language_model." + k
            out[k] = v
        return out
