"""GraniteMoE text model (IBM Granite 3.x MoE).

Port of mlx_vlm_tpu/models/granitemoe/granitemoe.py (TextConfig :27,
GraniteMoELanguageModel :48-59, sanitize :67-88): the Qwen-MoE decoder
with the muP multipliers: `embedding_multiplier` on the embeddings,
`residual_multiplier` on each residual branch (the `residual_scale`
hook), `attention_multiplier` as the attention scale and the logits
divided by `logits_scaling`.  HF checkpoints fuse each layer's experts:
`block_sparse_moe.input_linear` [E, 2I, D] splits into gate / up along
the out axis (each of a quantized triple's weight, scales and biases, as
numpy arrays or tensors), `output_linear` becomes down and `router.layer`
the router `mlp.gate`; mlx conversions keep `block_sparse_moe.switch_mlp.*`
and `block_sparse_moe.router.layer`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..qwen2_moe.config import TextConfig as _MoEText
from ..qwen2_moe.language import MoELanguageModel
from ..qwen2_moe.qwen2_moe import Model as _MoEModel


@dataclass
class TextConfig(_MoEText):
    model_type: str = "granitemoe"
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    norm_topk_prob: bool = True  # softmax over the selected experts
    attention_bias: bool = False
    rope_theta: float = 10000.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 0.0  # 0 -> default head_dim**-0.5
    tie_word_embeddings: bool = True

    def __post_init__(self):
        super().__post_init__()
        self.num_experts = self.num_local_experts


ModelConfig = TextConfig


class GraniteMoELanguageModel(MoELanguageModel):
    def __init__(self, args: TextConfig, config=None):
        super().__init__(args, config)
        self.residual_scale = args.residual_multiplier
        if args.attention_multiplier:
            self.scale = args.attention_multiplier

    def embed(self, params: dict, input_ids):
        return super().embed(params, input_ids) * self.args.embedding_multiplier

    def logits(self, params: dict, hidden):
        return super().logits(params, hidden) / self.args.logits_scaling


def split_halves(v) -> tuple:
    """[E, 2I, ...] -> two contiguous [E, I, ...] halves along axis 1, for
    a numpy array or a tensor (a quantized triple's bf16 scales and biases
    are tensors)."""
    if isinstance(v, torch.Tensor):
        return tuple(h.contiguous() for h in torch.chunk(v, 2, dim=1))
    return tuple(np.ascontiguousarray(h)
                 for h in np.split(np.asarray(v), 2, axis=1))


class Model(_MoEModel):
    language_model_class = GraniteMoELanguageModel
    RENAMES = ((".block_sparse_moe.switch_mlp.", ".mlp.experts."),
               (".block_sparse_moe.output_linear.", ".mlp.experts.down_proj."),
               (".block_sparse_moe.router.layer.", ".mlp.gate."))

    @classmethod
    def sanitize(cls, weights: dict) -> dict:
        out = {}
        for k, v in weights.items():
            if ".block_sparse_moe.input_linear." in k:
                # [E, 2I, D] (or its scales / biases) -> gate / up [E, I, ...]
                base = k.replace(".block_sparse_moe.input_linear.",
                                 ".mlp.experts.{}.")
                for name, half in zip(("gate_proj", "up_proj"),
                                      split_halves(v)):
                    out.update(super().sanitize({base.format(name): half}))
                continue
            out.update(super().sanitize({k: v}))
        return out
