"""Mixtral sparse-MoE text model.

Port of mlx_vlm_tpu/models/mixtral/mixtral.py (TextConfig :24, _EXPERT_RE
:41, sanitize :47): the Qwen-MoE decoder without a shared expert; its
softmax over the top-k logits equals the reference's softmax, top-k and
renormalisation (`norm_topk_prob`).  HF checkpoints keep one key per
expert, `block_sparse_moe.experts.{e}.w1|w3|w2`, folded into the stacked
gate / up / down, and the router `block_sparse_moe.gate` becomes
`mlp.gate`; mlx conversions keep `block_sparse_moe.switch_mlp.*` stacks,
renamed to `mlp.experts.*`.  Both renamings apply to the quantization
config's per-path entries too (`rename_key`), so an 8-bit router entry
under its checkpoint name is found.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..qwen2_moe.config import TextConfig as _MoEText
from ..qwen2_moe.qwen2_moe import Model as _MoEModel


@dataclass
class TextConfig(_MoEText):
    model_type: str = "mixtral"
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    norm_topk_prob: bool = True  # softmax over the selected experts
    attention_bias: bool = False
    rope_theta: float = 1e6

    def __post_init__(self):
        super().__post_init__()
        self.num_experts = self.num_local_experts


ModelConfig = TextConfig

_EXPERT_RE = re.compile(r"\.block_sparse_moe\.experts\.(\d+)\.(w1|w2|w3)\.")
_EXPERT_NAME = {"w1": "gate_proj", "w2": "down_proj", "w3": "up_proj"}


class Model(_MoEModel):
    RENAMES = ((".block_sparse_moe.switch_mlp.", ".mlp.experts."),
               (".block_sparse_moe.gate.", ".mlp.gate."))

    @classmethod
    def rename_key(cls, key: str) -> str:
        m = _EXPERT_RE.search(key)
        if m:
            return (key[: m.start()]
                    + f".mlp.experts.{m.group(1)}.{_EXPERT_NAME[m.group(2)]}."
                    + key[m.end():])
        return super().rename_key(key)
