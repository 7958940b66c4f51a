"""Random checkpoints and a byte-level tokenizer for tests and smoke runs.

Port of mlx_vlm_tpu/utils/testing.py (tiny_qwen2_vl_config :21,
qwen2_vl_2b_config :647 and qwen2_vl_7b_config :675 copied; qwen2_vl_hf_weights :59 draws the same
arrays for a seed from one list of tensor specs), plus:

- `mlx_quantized_checkpoint`: a random checkpoint in the layout of a 4- or
  8-bit mlx-community conversion (every language-model linear, lm_head and
  embed_tokens as uint32 codes + bf16 scales and biases; the vision tower
  dense bf16), drawn directly in that layout so that no float weights of
  full size are ever quantized on the host; `mlx_int4_checkpoint` is its
  4-bit case;
- `ByteTokenizer`: Qwen2-VL's special tokens at their public ids and one id
  per UTF-8 byte otherwise, so a processor works without `transformers`.

Everything is numpy on the host and made from a seed.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# Qwen2-VL's public special-token ids (tokenizer_config.json of the release)
QWEN2_VL_SPECIAL_TOKENS = {
    "<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
    "<|object_ref_start|>": 151646, "<|object_ref_end|>": 151647,
    "<|box_start|>": 151648, "<|box_end|>": 151649, "<|quad_start|>": 151650,
    "<|quad_end|>": 151651, "<|vision_start|>": 151652,
    "<|vision_end|>": 151653, "<|vision_pad|>": 151654,
    "<|image_pad|>": 151655, "<|video_pad|>": 151656,
}


def tiny_qwen2_vl_config(**overrides) -> dict:
    cfg = {
        "model_type": "qwen2_vl",
        "hidden_size": 64,
        "num_hidden_layers": 2,
        "intermediate_size": 128,
        "num_attention_heads": 4,
        "num_key_value_heads": 2,
        "rms_norm_eps": 1e-6,
        "vocab_size": 256,
        "rope_theta": 10000.0,
        "rope_scaling": {"type": "mrope", "mrope_section": [2, 3, 3]},
        "tie_word_embeddings": False,
        "max_position_embeddings": 1024,
        "image_token_id": 151655,
        "video_token_id": 151656,
        "vision_start_token_id": 151652,
        "vision_config": {
            "depth": 2,
            "embed_dim": 32,
            "hidden_size": 64,
            "num_heads": 4,
            "patch_size": 14,
            "mlp_ratio": 4.0,
            "in_channels": 3,
            "spatial_merge_size": 2,
            "temporal_patch_size": 2,
        },
    }
    # qwen2-vl uses huge special ids; shrink for tiny vocab tests
    if cfg["vocab_size"] <= 1024:
        cfg["image_token_id"] = 151655 % cfg["vocab_size"]
        cfg["video_token_id"] = 151656 % cfg["vocab_size"]
        cfg["vision_start_token_id"] = 151652 % cfg["vocab_size"]
    cfg.update(overrides)
    return cfg


def qwen2_vl_2b_config() -> dict:
    """Real Qwen2-VL-2B-Instruct dimensions (for benchmarking w/o weights)."""
    return tiny_qwen2_vl_config(
        hidden_size=1536,
        num_hidden_layers=28,
        intermediate_size=8960,
        num_attention_heads=12,
        num_key_value_heads=2,
        vocab_size=151936,
        rope_theta=1000000.0,
        rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
        image_token_id=151655,
        video_token_id=151656,
        vision_start_token_id=151652,
        vision_config={
            "depth": 32,
            "embed_dim": 1280,
            "hidden_size": 1536,
            "num_heads": 16,
            "patch_size": 14,
            "mlp_ratio": 4.0,
            "in_channels": 3,
            "spatial_merge_size": 2,
            "temporal_patch_size": 2,
        },
    )


def qwen2_vl_7b_config() -> dict:
    """Real Qwen2-VL-7B-Instruct dimensions."""
    return tiny_qwen2_vl_config(
        hidden_size=3584,
        num_hidden_layers=28,
        intermediate_size=18944,
        num_attention_heads=28,
        num_key_value_heads=4,
        vocab_size=152064,
        rope_theta=1000000.0,
        rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
        image_token_id=151655,
        video_token_id=151656,
        vision_start_token_id=151652,
        vision_config={
            "depth": 32,
            "embed_dim": 1280,
            "hidden_size": 3584,
            "num_heads": 16,
            "patch_size": 14,
            "mlp_ratio": 4.0,
            "in_channels": 3,
            "spatial_merge_size": 2,
            "temporal_patch_size": 2,
        },
    )


def qwen2_vl_tensor_specs(config: dict) -> list:
    """(HF key, shape, fill) of every tensor of a Qwen2-VL checkpoint, in the
    reference builder's draw order; fill is "rand", "ones" or "zeros"."""
    D = config["hidden_size"]
    V = config["vocab_size"]
    I = config["intermediate_size"]
    nh = config["num_attention_heads"]
    nkv = config["num_key_value_heads"]
    hd = D // nh
    specs = [("model.embed_tokens.weight", (V, D), "rand")]
    for i in range(config["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs += [
            (p + "input_layernorm.weight", (D,), "ones"),
            (p + "post_attention_layernorm.weight", (D,), "ones"),
            (p + "self_attn.q_proj.weight", (nh * hd, D), "rand"),
            (p + "self_attn.q_proj.bias", (nh * hd,), "rand"),
            (p + "self_attn.k_proj.weight", (nkv * hd, D), "rand"),
            (p + "self_attn.k_proj.bias", (nkv * hd,), "rand"),
            (p + "self_attn.v_proj.weight", (nkv * hd, D), "rand"),
            (p + "self_attn.v_proj.bias", (nkv * hd,), "rand"),
            (p + "self_attn.o_proj.weight", (D, nh * hd), "rand"),
            (p + "mlp.gate_proj.weight", (I, D), "rand"),
            (p + "mlp.up_proj.weight", (I, D), "rand"),
            (p + "mlp.down_proj.weight", (D, I), "rand"),
        ]
    specs.append(("model.norm.weight", (D,), "ones"))
    if not config.get("tie_word_embeddings"):
        specs.append(("lm_head.weight", (V, D), "rand"))
    vc = config["vision_config"]
    E = vc["embed_dim"]
    P = vc.get("patch_size", 14)
    T = vc.get("temporal_patch_size", 2)
    C = vc.get("in_channels", 3)
    m = vc.get("spatial_merge_size", 2)
    ratio = int(E * vc.get("mlp_ratio", 4.0))
    specs.append(("visual.patch_embed.proj.weight", (E, C, T, P, P), "rand"))
    for i in range(vc["depth"]):
        p = f"visual.blocks.{i}."
        specs += [
            (p + "norm1.weight", (E,), "ones"),
            (p + "norm1.bias", (E,), "zeros"),
            (p + "norm2.weight", (E,), "ones"),
            (p + "norm2.bias", (E,), "zeros"),
            (p + "attn.qkv.weight", (3 * E, E), "rand"),
            (p + "attn.qkv.bias", (3 * E,), "rand"),
            (p + "attn.proj.weight", (E, E), "rand"),
            (p + "attn.proj.bias", (E,), "rand"),
            (p + "mlp.fc1.weight", (ratio, E), "rand"),
            (p + "mlp.fc1.bias", (ratio,), "rand"),
            (p + "mlp.fc2.weight", (E, ratio), "rand"),
            (p + "mlp.fc2.bias", (E,), "rand"),
        ]
    hidden_m = E * m * m
    specs += [
        ("visual.merger.ln_q.weight", (E,), "ones"),
        ("visual.merger.ln_q.bias", (E,), "zeros"),
        ("visual.merger.mlp.0.weight", (hidden_m, hidden_m), "rand"),
        ("visual.merger.mlp.0.bias", (hidden_m,), "rand"),
        ("visual.merger.mlp.2.weight", (D, hidden_m), "rand"),
        ("visual.merger.mlp.2.bias", (D,), "rand"),
    ]
    return specs


def qwen2_vl_hf_weights(config: dict, seed: int = 0,
                        scale: float = 0.05) -> dict:
    """Random f32 weights with HF qwen2-vl checkpoint keys (visual.*,
    model.*); the same arrays as the reference's builder for a seed."""
    rng = np.random.default_rng(seed)
    w = {}
    for key, shape, fill in qwen2_vl_tensor_specs(config):
        if fill == "rand":
            w[key] = (rng.standard_normal(shape) * scale).astype(np.float32)
        else:
            w[key] = (np.ones if fill == "ones" else np.zeros)(shape, np.float32)
    return w


def _is_quantized_in_mlx(key: str) -> bool:
    """Keys an mlx-community Qwen2-VL conversion stores quantized: the
    language model's linears, lm_head and embed_tokens."""
    return key in ("model.embed_tokens.weight", "lm_head.weight") or (
        key.startswith("model.layers.") and key.endswith("_proj.weight"))


def mlx_quantized_checkpoint(config: dict, bits: int = 4, group_size: int = 64,
                             seed: int = 0, std: float = 0.02):
    """(config, weights) of a random `bits`-bit mlx-format Qwen2-VL
    checkpoint (bits 4 or 8).

    Quantized tensors: `<key>.weight` uint32 [out, in * bits / 32] (codes
    packed low bits first), `<key>.scales` and `<key>.biases` bf16
    [out, in/group].  Codes are uniform in [0, 2**bits) and each group's bias
    is -((2**bits - 1) / 2) * scale, with scales drawn so the dequantized
    weights have standard deviation ~std.  The vision tower, the q/k/v biases
    and the norms are dense bf16 (weights and biases ~ N(0, std), norms
    1 / 0).  Returns the config with its `quantization` entry added and a
    flat dict of numpy uint32 arrays and CPU torch.bfloat16 tensors."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    rng = np.random.default_rng(seed)
    levels = 2**bits
    s_mean = std / float(np.sqrt((levels**2 - 1) / 12.0))  # uniform codes
    w = {}
    for key, shape, fill in qwen2_vl_tensor_specs(config):
        if _is_quantized_in_mlx(key):
            n, k = shape
            if k % group_size or (k * bits) % 32:
                raise ValueError(f"{key}: in-features {k} not a multiple of "
                                 f"the group {group_size} or of a word")
            s = rng.uniform(0.75 * s_mean, 1.25 * s_mean,
                            size=(n, k // group_size)).astype(np.float32)
            base = key[: -len(".weight")]
            w[key] = rng.integers(0, 2**32, size=(n, k * bits // 32),
                                  dtype=np.uint32)
            w[base + ".scales"] = torch.from_numpy(s).to(torch.bfloat16)
            w[base + ".biases"] = torch.from_numpy(
                -((levels - 1) / 2) * s).to(torch.bfloat16)
        elif fill == "rand":
            w[key] = torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32) * std).to(
                    torch.bfloat16)
        else:
            w[key] = (torch.ones if fill == "ones" else torch.zeros)(
                shape, dtype=torch.bfloat16)
    cfg = {**config, "quantization": {"group_size": group_size, "bits": bits}}
    return cfg, w


def mlx_int4_checkpoint(config: dict, seed: int = 0, group_size: int = 64,
                        std: float = 0.02):
    """The 4-bit case of `mlx_quantized_checkpoint` (the same draws)."""
    return mlx_quantized_checkpoint(config, bits=4, group_size=group_size,
                                    seed=seed, std=std)


def _byte_unicode() -> list:
    """GPT-2 byte-level alphabet: byte -> printable unicode character."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    table = dict(zip(bs, cs))
    return [chr(table[b]) for b in range(256)]


class ByteTokenizer:
    """Qwen2-VL special tokens at their public ids; every other UTF-8 byte is
    its own id (0-255).  Enough of the HF tokenizer surface for the
    processor, the chat-template fallback and the detokenizer."""

    eos_token_id = QWEN2_VL_SPECIAL_TOKENS["<|im_end|>"]
    pad_token_id = QWEN2_VL_SPECIAL_TOKENS["<|endoftext|>"]

    def __init__(self):
        self._special = dict(QWEN2_VL_SPECIAL_TOKENS)
        self._by_id = {v: k for k, v in self._special.items()}
        names = sorted(self._special, key=len, reverse=True)
        self._split = re.compile("(" + "|".join(map(re.escape, names)) + ")")
        self._bytes = _byte_unicode()

    @property
    def all_special_ids(self) -> list:
        return sorted(self._by_id)

    def encode(self, text: str) -> list:
        ids = []
        for piece in self._split.split(text):
            if piece in self._special:
                ids.append(self._special[piece])
            elif piece:
                ids.extend(piece.encode("utf-8"))
        return ids

    def __call__(self, text, return_tensors="np", padding=True,
                 padding_side="left", **kw):
        texts = [text] if isinstance(text, str) else list(text)
        seqs = [self.encode(t) for t in texts]
        L = max(len(s) for s in seqs)
        ids = np.full((len(seqs), L), self.pad_token_id, np.int64)
        mask = np.zeros((len(seqs), L), np.int64)
        for r, s in enumerate(seqs):
            sl = slice(L - len(s), L) if padding_side == "left" else slice(0, len(s))
            ids[r, sl] = s
            mask[r, sl] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out, buf = [], bytearray()
        for i in np.asarray(ids).reshape(-1).tolist():
            if i in self._by_id:
                out.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()
                if not skip_special_tokens:
                    out.append(self._by_id[i])
            elif 0 <= i < 256:
                buf.append(i)
        out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def convert_ids_to_tokens(self, ids):
        def one(i):
            i = int(i)
            if i in self._by_id:
                return self._by_id[i]
            return self._bytes[i] if 0 <= i < 256 else None

        if isinstance(ids, (list, tuple, np.ndarray)):
            return [one(i) for i in ids]
        return one(ids)
