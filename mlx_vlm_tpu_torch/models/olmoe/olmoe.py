"""OLMoE sparse-MoE text model.

Port of mlx_vlm_tpu/models/olmoe/olmoe.py (TextConfig :24, _qkv :36-48):
the Qwen-MoE decoder without a shared expert, its q / k RMSNorms taken
over the whole flat projection (n_heads * head_dim, n_kv_heads * head_dim)
before the head reshape, unlike qwen3's per-head norms.  The checkpoint's
`mlp.gate` / `mlp.experts.{e}.*` (HF) or `mlp.switch_mlp.*` (mlx) keys are
the Qwen-MoE ones.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...core.layers import linear, rms_norm
from ..qwen2_moe.config import TextConfig as _MoEText
from ..qwen2_moe.language import MoELanguageModel
from ..qwen2_moe.qwen2_moe import Model as _MoEModel


@dataclass
class TextConfig(_MoEText):
    model_type: str = "olmoe"
    num_experts: int = 64
    num_experts_per_tok: int = 8
    norm_topk_prob: bool = False
    attention_bias: bool = False
    rope_theta: float = 10000.0


ModelConfig = TextConfig


class OlmoeLanguageModel(MoELanguageModel):
    def _qkv(self, p, x):
        B, S, _ = x.shape
        eps = self.args.rms_norm_eps
        # flat-vector norms over n_heads * head_dim (the reference's :44-45)
        q = rms_norm(p["q_norm"], linear(p["q_proj"], x), eps)
        k = rms_norm(p["k_norm"], linear(p["k_proj"], x), eps)
        v = linear(p["v_proj"], x)
        q = q.reshape(B, S, self.n_heads, self.head_dim)
        k = k.reshape(B, S, self.n_kv_heads, self.head_dim)
        v = v.reshape(B, S, self.n_kv_heads, self.head_dim)
        return tuple(a.transpose(1, 2) for a in (q, k, v))


class Model(_MoEModel):
    language_model_class = OlmoeLanguageModel
