"""GPT-BigCode / StarCoder v1: a fused c_attn with multi-query attention,
learned absolute positions, a biased gelu MLP and the tied head.

Port of mlx_vlm_tpu/models/gpt_bigcode/__init__.py (ModelConfig :23,
sanitize :53) on models/classic_base.py.  c_attn's rows [q | k | v]
(D + kvd + kvd) split into q / k / v, an mlx-quantized c_attn's codes,
scales and biases alike, where the reference splits only `weight` and
`bias` (ROADMAP Queue 3, known faults).  As in the reference, an
`lm_head.*` key stays outside the language model's tree, so the head is
the tied table.
"""

from __future__ import annotations

import re

from ..classic_base import (PARAM_RE, ClassicConfig, ClassicLanguageModel,
                            ClassicModel, split_rows)

_ATTN_RE = re.compile(rf"^h\.(\d+)\.attn\.c_attn\.{PARAM_RE}$")


class ModelConfig(ClassicConfig):
    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        n_head = d.get("n_head", 12)
        n_embd = d.get("n_embd", 768)
        multi_query = d.get("multi_query", True)
        return cls(
            model_type="gpt_bigcode",
            hidden_size=n_embd,
            num_hidden_layers=d.get("n_layer", 12),
            num_attention_heads=n_head,
            num_key_value_heads=(
                d.get("num_key_value_heads")
                or (1 if multi_query else n_head)),
            intermediate_size=d.get("n_inner") or 4 * n_embd,
            vocab_size=d.get("vocab_size", 49152),
            layer_norm_eps=d.get("layer_norm_epsilon", 1e-5),
            max_position_embeddings=d.get("n_positions", 8192),
            tie_word_embeddings=d.get("tie_word_embeddings", True),
            rope_pct=0.0,
            norm="layer",
            parallel=False,
            act="gelu",
        )


LanguageModel = ClassicLanguageModel


class Model(ClassicModel):
    def sanitize(self, weights: dict) -> dict:
        cfg = self.config
        D = cfg.hidden_size
        kvd = cfg.num_key_value_heads * cfg.head_dim
        out = {}
        for k, v in weights.items():
            k = k[len("transformer."):] if k.startswith("transformer.") else k
            if re.match(r"^h\.\d+\.attn\.bias$", k) or "masked_bias" in k:
                continue
            m = _ATTN_RE.match(k)
            if m:
                i, suf = m.group(1), m.group(2)
                base = f"language_model.model.layers.{i}.attn"
                for name, part in zip("qkv", split_rows(v, (D, kvd, kvd))):
                    out[f"{base}.{name}_proj.{suf}"] = part
                continue
            k = re.sub(r"^h\.(\d+)\.", r"language_model.model.layers.\1.", k)
            k = k.replace(".ln_1.", ".ln1.").replace(".ln_2.", ".ln2.")
            k = k.replace(".attn.c_proj.", ".attn.o_proj.")
            k = k.replace(".mlp.c_fc.", ".mlp.fc1.")
            k = k.replace(".mlp.c_proj.", ".mlp.fc2.")
            if not k.startswith(("language_model.", "lm_head.")):
                k = "language_model.model." + k
            out[k] = v
        return out
