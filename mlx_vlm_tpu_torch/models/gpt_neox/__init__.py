"""GPT-NeoX / Pythia: a per-head interleaved fused qkv, a partial rotary
(rotary_pct), an optional parallel residual and a gelu-tanh MLP.

Port of mlx_vlm_tpu/models/gpt_neox/__init__.py (ModelConfig :20,
sanitize :45) on models/classic_base.py.  The fused query_key_value's
rows [h, {q, k, v}, head_dim] are de-interleaved per head; an
mlx-quantized one de-interleaves its codes, scales and biases alike, where
the reference takes `weight` and `bias` only (ROADMAP Queue 3, known
faults).
"""

from __future__ import annotations

import re

from ..base import contiguous
from ..classic_base import (PARAM_RE, ClassicConfig, ClassicLanguageModel,
                            ClassicModel)

_QKV_RE = re.compile(
    rf"^gpt_neox\.layers\.(\d+)\.attention\.query_key_value\.{PARAM_RE}$")


class ModelConfig(ClassicConfig):
    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        return cls(
            model_type="gpt_neox",
            hidden_size=d.get("hidden_size", 2048),
            num_hidden_layers=d.get("num_hidden_layers", 24),
            num_attention_heads=d.get("num_attention_heads", 16),
            intermediate_size=d.get("intermediate_size"),
            vocab_size=d.get("vocab_size", 50432),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 2048),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            rope_pct=d.get("rotary_pct", 0.25),
            rope_theta=d.get("rotary_emb_base", 10000.0),
            norm="layer",
            parallel=d.get("use_parallel_residual", True),
            act="gelu_tanh",
        )


LanguageModel = ClassicLanguageModel


class Model(ClassicModel):
    def sanitize(self, weights: dict) -> dict:
        a = self.config
        H, hd = a.num_attention_heads, a.head_dim
        out = {}
        for k, v in weights.items():
            if "rotary_emb" in k or "attention.bias" in k or (
                    "masked_bias" in k):
                continue
            m = _QKV_RE.match(k)
            if m:
                i, suf = m.group(1), m.group(2)
                # per-head interleave: rows [h, {q, k, v}, hd]
                rest = tuple(v.shape[1:])
                v3 = v.reshape(H, 3, hd, *rest)
                base = f"language_model.model.layers.{i}.attn"
                for j, name in enumerate("qkv"):
                    out[f"{base}.{name}_proj.{suf}"] = contiguous(
                        v3[:, j].reshape(H * hd, *rest))
                continue
            k = re.sub(r"^gpt_neox\.layers\.(\d+)\.",
                       r"language_model.model.layers.\1.", k)
            k = k.replace(".input_layernorm.", ".ln1.")
            k = k.replace(".post_attention_layernorm.", ".ln2.")
            k = k.replace(".attention.dense.", ".attn.o_proj.")
            k = k.replace(".mlp.dense_h_to_4h.", ".mlp.fc1.")
            k = k.replace(".mlp.dense_4h_to_h.", ".mlp.fc2.")
            if k.startswith("gpt_neox.embed_in."):
                k = "language_model.model.wte." + k[len("gpt_neox.embed_in."):]
            elif k.startswith("gpt_neox.final_layer_norm."):
                k = ("language_model.model.ln_f."
                     + k[len("gpt_neox.final_layer_norm."):])
            elif k.startswith("embed_out."):
                k = "language_model.lm_head." + k[len("embed_out."):]
            out[k] = v
        return out
