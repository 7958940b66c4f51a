"""StableLM: a partial rotary, a SwiGLU MLP, an optional parallel residual
and per-head q / k LayerNorm stacks.

Port of mlx_vlm_tpu/models/stablelm/__init__.py (ModelConfig :14,
sanitize :48) on models/classic_base.py.  Every key of a module is
renamed, the `.scales` / `.biases` of an mlx-quantized embedding table
too, where the reference renames the table's `weight` alone (ROADMAP
Queue 3, known faults).
"""

from __future__ import annotations

import re

from ..classic_base import (ClassicConfig, ClassicLanguageModel, ClassicModel,
                            stack)


class ModelConfig(ClassicConfig):
    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        return cls(
            model_type="stablelm",
            hidden_size=d.get("hidden_size", 2560),
            num_hidden_layers=d.get("num_hidden_layers", 32),
            num_attention_heads=d.get("num_attention_heads", 32),
            num_key_value_heads=d.get("num_key_value_heads", 32),
            intermediate_size=d.get("intermediate_size"),
            vocab_size=d.get("vocab_size", 50304),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            rope_pct=d.get("partial_rotary_factor", 0.25),
            rope_theta=d.get("rope_theta", 10000.0),
            norm="layer",
            parallel=d.get("use_parallel_residual", False),
            parallel_shared_ln=True,  # the reference shares input_layernorm
            act="swiglu",
            qk_headnorm=d.get("qk_layernorm", False),
        )


LanguageModel = ClassicLanguageModel

_NORMSTACK_RE = re.compile(
    r"^model\.layers\.(\d+)\.self_attn\.(q|k)_layernorm\.norms\.(\d+)"
    r"\.weight$")


class Model(ClassicModel):
    def sanitize(self, weights: dict) -> dict:
        out = {}
        stacks: dict = {}
        for k, v in weights.items():
            if "rotary_emb" in k:
                continue
            m = _NORMSTACK_RE.match(k)
            if m:
                i, which, h = m.group(1), m.group(2), int(m.group(3))
                stacks.setdefault((i, which), {})[h] = v
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
        for (i, which), heads in stacks.items():
            out[f"language_model.model.layers.{i}.attn.{which}_norms"
                ".weight"] = stack([heads[h] for h in sorted(heads)])
        return out
