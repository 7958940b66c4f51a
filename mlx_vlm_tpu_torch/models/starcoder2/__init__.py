"""StarCoder2: GQA with a full rotary, LayerNorm, a biased gelu c_fc /
c_proj MLP and a tied or separate head.

Port of mlx_vlm_tpu/models/starcoder2/__init__.py (ModelConfig :13,
sanitize :39) on models/classic_base.py.  Every key of a module is
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
        return cls(
            model_type="starcoder2",
            hidden_size=d.get("hidden_size", 3072),
            num_hidden_layers=d.get("num_hidden_layers", 30),
            num_attention_heads=d.get("num_attention_heads", 24),
            num_key_value_heads=d.get("num_key_value_heads", 2),
            intermediate_size=d.get("intermediate_size"),
            vocab_size=d.get("vocab_size", 49152),
            layer_norm_eps=d.get("norm_epsilon", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 16384),
            tie_word_embeddings=d.get("tie_word_embeddings", True),
            rope_pct=1.0,
            rope_theta=d.get("rope_theta", 100000.0),
            norm="layer",
            parallel=False,
            act="gelu",
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
            k = k.replace(".mlp.c_fc.", ".mlp.fc1.")
            k = k.replace(".mlp.c_proj.", ".mlp.fc2.")
            if k.startswith("model.embed_tokens."):
                k = ("language_model.model.wte."
                     + k[len("model.embed_tokens."):])
            elif k.startswith("model.norm."):
                k = "language_model.model.ln_f." + k[len("model.norm."):]
            elif k.startswith("lm_head."):
                k = "language_model." + k
            out[k] = v
        return out
