"""Phi-1 / Phi-2: a parallel block sharing one LayerNorm, a partial rotary
(factor 0.4), a gelu-tanh MLP and a biased head.

Port of mlx_vlm_tpu/models/phi/__init__.py (ModelConfig :13, sanitize
:40) on models/classic_base.py.  Every key of a module is renamed, the
`.scales` / `.biases` of an mlx-quantized embedding table too, where the
reference renames the table's `weight` alone (ROADMAP Queue 3, known
faults).
"""

from __future__ import annotations

import re

from ..classic_base import ClassicConfig, ClassicLanguageModel, ClassicModel


class ModelConfig(ClassicConfig):
    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        return cls(
            model_type="phi",
            hidden_size=d.get("hidden_size", 2560),
            num_hidden_layers=d.get("num_hidden_layers", 32),
            num_attention_heads=d.get("num_attention_heads", 32),
            num_key_value_heads=d.get("num_key_value_heads"),
            intermediate_size=d.get("intermediate_size"),
            vocab_size=d.get("vocab_size", 51200),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 2048),
            tie_word_embeddings=False,
            rope_pct=d.get("partial_rotary_factor", 0.4),
            rope_theta=d.get("rope_theta", 10000.0),
            norm="layer",
            parallel=True,
            parallel_shared_ln=True,
            act="gelu_tanh",
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
            k = k.replace(".self_attn.dense.", ".attn.o_proj.")
            k = k.replace(".self_attn.", ".attn.")
            if k.startswith("model.embed_tokens."):
                k = ("language_model.model.wte."
                     + k[len("model.embed_tokens."):])
            elif k.startswith("model.final_layernorm."):
                k = ("language_model.model.ln_f."
                     + k[len("model.final_layernorm."):])
            elif k.startswith("lm_head."):
                k = "language_model." + k
            out[k] = v
        return out
