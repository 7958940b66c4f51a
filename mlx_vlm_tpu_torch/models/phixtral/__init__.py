"""Phixtral: phi-2's parallel blocks with a mixture of gelu experts.

Port of mlx_vlm_tpu/models/phixtral/__init__.py (ModelConfig :31,
LanguageModel._mlp :59, sanitize :81) on models/classic_base.py.  The
fused Wqkv splits into q / k / v; the per-expert fc1 / fc2 are stacked
[E, ...] and run through `core/moe.py`'s `switch_mlp` with gelu-tanh and
their biases, routed by the top k of the f32 gate logits (a quantized gate
dequantized first), softmaxed over those k (on the card K5's
expert-indexed GEMV at decode, K5 per expert in long prefill chunks).  An mlx-quantized checkpoint's codes, scales and
biases split and stack alike, where the reference takes `weight` and
`bias` only (ROADMAP Queue 3, known faults).
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from ...core.layers import dense_weight
from ...core.moe import switch_mlp
from ..classic_base import (PARAM_RE, ClassicConfig, ClassicLanguageModel,
                            ClassicModel, split_rows, stack)

_QKV_RE = re.compile(rf"^transformer\.h\.(\d+)\.mixer\.Wqkv\.{PARAM_RE}$")
_EXPERT_RE = re.compile(
    rf"^transformer\.h\.(\d+)\.moe\.mlp\.(\d+)\.(fc1|fc2)\.{PARAM_RE}$")


class ModelConfig(ClassicConfig):
    num_local_experts: int = 4
    num_experts_per_tok: int = 2

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        dims = d.get("model_dim", d.get("hidden_size", 2560))
        heads = d.get("num_heads", d.get("num_attention_heads", 32))
        cfg = cls(
            model_type="phixtral",
            hidden_size=dims,
            num_hidden_layers=d.get("num_layers",
                                    d.get("num_hidden_layers", 32)),
            num_attention_heads=heads,
            intermediate_size=4 * dims,
            vocab_size=d.get("num_vocab", d.get("vocab_size", 51200)),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 2048),
            tie_word_embeddings=False,
            rope_pct=d.get("rotary_dim", 32) / (dims // heads),
            norm="layer",
            parallel=True,
            parallel_shared_ln=True,
            act="gelu_tanh",
        )
        cfg.num_local_experts = d.get("num_local_experts", 4)
        cfg.num_experts_per_tok = d.get("num_experts_per_tok", 2)
        return cfg


def _gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


class LanguageModel(ClassicLanguageModel):
    def __init__(self, args: ModelConfig, config=None):
        super().__init__(args, config)
        self.top_k = args.num_experts_per_tok

    def _mlp(self, p, x):
        B, S, D = x.shape
        flat = x.reshape(B * S, D)
        # f32 gate logits of the gate's weight, dequantized if quantized
        gates = flat.float() @ dense_weight(p["gate"]["weight"]).float().T
        top, idx = torch.topk(gates, self.top_k, dim=-1)
        wts = torch.softmax(top, dim=-1).to(x.dtype)
        out = switch_mlp(flat, p["fc1"]["weight"], p["fc2"]["weight"], idx,
                         wts, act=_gelu_tanh,
                         biases=(p["fc1"]["bias"], p["fc2"]["bias"]))
        return out.reshape(B, S, D)


class Model(ClassicModel):
    language_model_class = LanguageModel

    def sanitize(self, weights: dict) -> dict:
        D = self.config.hidden_size
        out = {}
        stacks: dict = {}
        for k, v in weights.items():
            if "rotary_emb" in k:
                continue
            m = _QKV_RE.match(k)
            if m:
                i, suf = m.group(1), m.group(2)
                base = f"language_model.model.layers.{i}.attn"
                for name, part in zip("qkv", split_rows(v, (D, D, D))):
                    out[f"{base}.{name}_proj.{suf}"] = part
                continue
            m = _EXPERT_RE.match(k)
            if m:
                i, e, proj, suf = (m.group(1), int(m.group(2)),
                                   m.group(3), m.group(4))
                stacks.setdefault((i, proj, suf), {})[e] = v
                continue
            if k.startswith("transformer.embd.wte."):
                out["language_model.model.wte."
                    + k[len("transformer.embd.wte."):]] = v
                continue
            if k.startswith("lm_head.ln."):
                out["language_model.model.ln_f."
                    + k[len("lm_head.ln."):]] = v
                continue
            if k.startswith("lm_head.linear."):
                out["language_model.lm_head."
                    + k[len("lm_head.linear."):]] = v
                continue
            k = re.sub(r"^transformer\.h\.(\d+)\.",
                       r"language_model.model.layers.\1.", k)
            k = k.replace(".ln.", ".ln1.")
            k = k.replace(".mixer.out_proj.", ".attn.o_proj.")
            k = k.replace(".moe.gate.", ".mlp.gate.")
            out[k] = v
        for (i, proj, suf), items in stacks.items():
            out[f"language_model.model.layers.{i}.mlp.{proj}.{suf}"] = stack(
                [items[e] for e in sorted(items)])
        return out
