"""GPT-2: a fused Conv1D c_attn, learned absolute positions, a gelu-tanh
MLP and the tied head.

Port of mlx_vlm_tpu/models/gpt2/__init__.py (ModelConfig :18, sanitize
:42) on models/classic_base.py.  HF's Conv1D weights [in, out] are
transposed to the Linear layout and c_attn's rows split into q / k / v;
an mlx conversion ("model."-prefixed keys, or packed uint32 codes) is in
the Linear layout already, and its fused c_attn splits its codes, scales
and biases alike, where the reference splits only `weight` and `bias`
(ROADMAP Queue 3, known faults).
"""

from __future__ import annotations

import re

from ..base import contiguous
from ..classic_base import (PARAM_RE, ClassicConfig, ClassicLanguageModel,
                            ClassicModel, is_codes, split_rows)

_ATTN_RE = re.compile(rf"^h\.(\d+)\.attn\.c_attn\.{PARAM_RE}$")


class ModelConfig(ClassicConfig):
    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        return cls(
            model_type="gpt2",
            hidden_size=d.get("n_embd", 768),
            num_hidden_layers=d.get("n_layer", 12),
            num_attention_heads=d.get("n_head", 12),
            vocab_size=d.get("vocab_size", 50257),
            layer_norm_eps=d.get("layer_norm_epsilon", 1e-5),
            max_position_embeddings=d.get("n_positions", 1024),
            tie_word_embeddings=True,
            rope_pct=0.0,
            norm="layer",
            parallel=False,
            act="gelu_tanh",
        )


LanguageModel = ClassicLanguageModel


class Model(ClassicModel):
    def sanitize(self, weights: dict) -> dict:
        D = self.config.hidden_size
        out = {}
        for k, v in weights.items():
            mlx = k.startswith("model.")
            for pre in ("transformer.", "model."):
                if k.startswith(pre):
                    k = k[len(pre):]
            if re.match(r"^h\.\d+\.attn\.bias$", k) or "attn.masked_bias" in k:
                continue
            # HF Conv1D stores [in, out]: transpose to the Linear layout
            if (k.endswith(".weight") and not mlx and not is_codes(v) and (
                    ".c_attn." in k or ".c_proj." in k or ".c_fc." in k)):
                v = contiguous(v.T)
            m = _ATTN_RE.match(k)
            if m:
                i, suf = m.group(1), m.group(2)
                base = f"language_model.model.layers.{i}.attn"
                for name, part in zip(("q", "k", "v"),
                                      split_rows(v, (D, D, D))):
                    out[f"{base}.{name}_proj.{suf}"] = part
                continue
            k = re.sub(r"^h\.(\d+)\.", r"language_model.model.layers.\1.",
                       k)
            k = k.replace(".ln_1.", ".ln1.").replace(".ln_2.", ".ln2.")
            k = k.replace(".attn.c_proj.", ".attn.o_proj.")
            k = k.replace(".mlp.c_fc.", ".mlp.fc1.")
            k = k.replace(".mlp.c_proj.", ".mlp.fc2.")
            if k.startswith(("wte.", "wpe.", "ln_f.")):
                k = "language_model.model." + k
            out[k] = v
        return out
