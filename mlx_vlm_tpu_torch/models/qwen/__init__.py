"""Qwen-1: a fused c_attn, RMSNorm, a half-width SwiGLU (w2 gates w1), a
full rotary and transformer.h.* keys.

Port of mlx_vlm_tpu/models/qwen/__init__.py (ModelConfig :15, sanitize
:40) on models/classic_base.py.  c_attn's rows split into q / k / v, an
mlx-quantized c_attn's codes, scales and biases alike, where the reference
splits only `weight` and `bias` (ROADMAP Queue 3, known faults).
"""

from __future__ import annotations

import re

from ..classic_base import (PARAM_RE, ClassicConfig, ClassicLanguageModel,
                            ClassicModel, split_rows)

_ATTN_RE = re.compile(rf"^transformer\.h\.(\d+)\.attn\.c_attn\.{PARAM_RE}$")


class ModelConfig(ClassicConfig):
    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        return cls(
            model_type="qwen",
            hidden_size=d.get("hidden_size", 2048),
            num_hidden_layers=d.get("num_hidden_layers", 24),
            num_attention_heads=d.get("num_attention_heads", 16),
            head_dim=d.get("kv_channels"),
            intermediate_size=d.get("intermediate_size", 11008) // 2,
            vocab_size=d.get("vocab_size", 151936),
            layer_norm_eps=d.get("layer_norm_epsilon", 1e-6),
            max_position_embeddings=d.get("max_position_embeddings", 8192),
            tie_word_embeddings=False,
            rope_pct=1.0,
            rope_theta=d.get("rotary_emb_base", 10000.0),
            norm="rms",
            parallel=False,
            act="swiglu",
        )


LanguageModel = ClassicLanguageModel


class Model(ClassicModel):
    def sanitize(self, weights: dict) -> dict:
        D = self.config.hidden_size
        out = {}
        for k, v in weights.items():
            if "rotary_emb" in k:
                continue
            m = _ATTN_RE.match(k)
            if m:
                i, suf = m.group(1), m.group(2)
                base = f"language_model.model.layers.{i}.attn"
                for name, part in zip("qkv", split_rows(v, (D, D, D))):
                    out[f"{base}.{name}_proj.{suf}"] = part
                continue
            k = re.sub(r"^transformer\.h\.(\d+)\.",
                       r"language_model.model.layers.\1.", k)
            k = k.replace(".ln_1.", ".ln1.").replace(".ln_2.", ".ln2.")
            k = k.replace(".attn.c_proj.", ".attn.o_proj.")
            # swiglu(a2, a1): w2 gates, w1 is the value branch
            k = k.replace(".mlp.w2.", ".mlp.gate_proj.")
            k = k.replace(".mlp.w1.", ".mlp.up_proj.")
            k = k.replace(".mlp.c_proj.", ".mlp.down_proj.")
            if k.startswith("transformer.wte."):
                k = "language_model.model.wte." + k[len("transformer.wte."):]
            elif k.startswith("transformer.ln_f."):
                k = ("language_model.model.ln_f."
                     + k[len("transformer.ln_f."):])
            elif k.startswith("lm_head."):
                k = "language_model." + k
            out[k] = v
        return out
