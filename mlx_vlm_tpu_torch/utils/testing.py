"""Random checkpoints and a byte-level tokenizer for tests and smoke runs.

Port of mlx_vlm_tpu/utils/testing.py (tiny_qwen2_vl_config :21,
tiny_qwen2_5_vl_config :139, qwen2_vl_2b_config :647 and
qwen2_vl_7b_config :675 copied; qwen2_vl_hf_weights :59 and
qwen2_5_vl_hf_weights :178 draw the same arrays for a seed), plus:

- `tiny_qwen3_vl_config` / `qwen3_vl_hf_weights`: the JAX package's Qwen3-VL
  test model (tests/test_qwen3_vl.py:16-116), copied;
- `qwen2_5_vl_7b_config` and `qwen3_vl_8b_config`: the published widths of
  Qwen/Qwen2.5-VL-7B-Instruct and Qwen/Qwen3-VL-8B-Instruct (config.json);
- `tiny_qwen3_vl_moe_config` / `qwen3_vl_moe_hf_weights`: the JAX package's
  Qwen3-VL-MoE test model (tests/test_qwen3_vl_moe.py:14-50, both fused
  expert layouts), copied; `qwen3_vl_moe_30b_a3b_config`: the published
  widths of Qwen/Qwen3-VL-30B-A3B-Instruct (config.json);
- `mlx_quantized_checkpoint`: a random checkpoint of any of the four
  families in the layout of a 4- or 8-bit mlx-community conversion (every
  language-model linear, lm_head and embed_tokens as uint32 codes + bf16
  scales and biases; Qwen3-VL-MoE's routers and its `switch_mlp` expert
  stacks too, the routers optionally at 8 bits under per-path entries, as
  mlx-community's MoE conversions write them; the vision tower dense
  bf16), drawn directly in that layout so that no float weights of full
  size are ever quantized on the host; `mlx_int4_checkpoint` is its 4-bit
  case;
- `tiny_llama_config` / `llama_hf_weights` and `tiny_llava_config` /
  `llava_hf_weights`: the JAX package's llama and LLaVA test models
  (mlx_vlm_tpu/utils/testing.py:228-382), copied (the same arrays for a
  seed); `llama_3_1_8b_config` and `llava_1_5_7b_config`: the published
  widths of meta-llama/Llama-3.1-8B-Instruct and llava-hf/llava-1.5-7b-hf
  (config.json);
- `tiny_paligemma_config` / `paligemma_hf_weights`: the JAX package's
  PaliGemma test model (mlx_vlm_tpu/utils/testing.py:387-490), copied (the
  same arrays for a seed), its gemma or gemma2 text model alone as
  `tiny_gemma_text_config` / `gemma_text_hf_weights`;
  `paligemma2_3b_224_config` and `paligemma_3b_224_config`: the published
  widths of google/paligemma2-3b-pt-224 and google/paligemma-3b-pt-224
  (config.json), and `PALIGEMMA_SPECIAL_TOKENS`;
- the text MoE decoders (`MOE_TEXT_TYPES`): `tiny_qwen2_moe_config` /
  `qwen2_moe_hf_weights`, the JAX package's Qwen-MoE test model
  (mlx_vlm_tpu/utils/testing.py:275-313), copied; `tiny_moe_text_config`
  and `moe_text_hf_weights` for each family on it, in its HF or mlx
  layout; the published widths of Qwen/Qwen3-30B-A3B,
  Qwen/Qwen1.5-MoE-A2.7B, mistralai/Mixtral-8x7B-v0.1,
  allenai/OLMoE-1B-7B-0924, microsoft/Phi-3.5-MoE-instruct and
  ibm-granite/granite-3.0-3b-a800m-instruct (config.json); and
  `MOE_TEXT_SPECIAL_TOKENS` for the vocabularies that do not hold Qwen's
  ids;
- `ByteTokenizer`: Qwen2-VL's special tokens at their public ids (Qwen2.5-VL
  and Qwen3-VL keep them), or another family's (`LLAMA3_SPECIAL_TOKENS`,
  `LLAVA_SPECIAL_TOKENS`), and one id per UTF-8 byte otherwise, so a
  processor works without `transformers`;
- `synthetic_video`: seeded uint8 frames of a clip, at any size (a tiny
  one for the CPU tests, 448 x 448 for the card);
- the target-coupled drafters' config.json dicts over a llama target
  (`eagle3_drafter_config`, `mtp_drafter_config`,
  `dflash_drafter_config`): `tiny_drafter_configs` over the tiny llama
  target (the JAX package's test drafters, tests/test_speculative.py:
  181-188, tests/test_dflash.py:43-56) and `llama_3_1_8b_drafter_configs`
  at Llama-3.1-8B's widths (one drafter layer for EAGLE-3, capturing
  layers 2, 16 and 29, and MTP; DFlash's 5 layers, block 16 and target
  layers 1, 8, 15, 22 and 29, the reference's defaults), and
  `write_drafter_checkpoint`, which writes such a drafter's directory
  (without the embedding and head that it shares with its target).

Everything is numpy on the host and made from a seed.
"""

from __future__ import annotations

import re
from typing import Optional

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
# Llama-3.1's (tokenizer_config.json of meta-llama/Llama-3.1-8B-Instruct)
LLAMA3_SPECIAL_TOKENS = {
    "<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
    "<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
    "<|eom_id|>": 128008, "<|eot_id|>": 128009,
}
# LLaVA-1.5's (llava-hf/llava-1.5-7b-hf: Llama-2's and <image>, <pad>)
LLAVA_SPECIAL_TOKENS = {"<s>": 1, "</s>": 2, "<image>": 32000,
                        "<pad>": 32001}
# PaliGemma's (Gemma's <pad> / <eos> / <bos> and PaliGemma's <image>)
PALIGEMMA_SPECIAL_TOKENS = {"<pad>": 0, "<eos>": 1, "<bos>": 2,
                            "<image>": 257152}


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


def _draw(specs: list, rng, scale: float) -> dict:
    """f32 arrays for `specs`, "rand" (and "qrand") ones drawn from `rng` in
    order."""
    w = {}
    for key, shape, fill in specs:
        if fill in ("rand", "qrand"):
            w[key] = (rng.standard_normal(shape) * scale).astype(np.float32)
        else:
            w[key] = (np.ones if fill == "ones" else np.zeros)(shape, np.float32)
    return w


def qwen2_vl_hf_weights(config: dict, seed: int = 0,
                        scale: float = 0.05) -> dict:
    """Random f32 weights with HF qwen2-vl checkpoint keys (visual.*,
    model.*); the same arrays as the reference's builder for a seed."""
    return _draw(qwen2_vl_tensor_specs(config), np.random.default_rng(seed),
                 scale)


def tiny_qwen2_5_vl_config(**overrides) -> dict:
    cfg = {
        "model_type": "qwen2_5_vl",
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
        "image_token_id": 151655 % 256,
        "video_token_id": 151656 % 256,
        "vision_start_token_id": 151652 % 256,
        "vision_config": {
            "depth": 3,
            "hidden_size": 32,
            "intermediate_size": 64,
            "out_hidden_size": 64,
            "num_heads": 4,
            "patch_size": 14,
            "in_channels": 3,
            "spatial_merge_size": 2,
            "temporal_patch_size": 2,
            "window_size": 56,  # vit_ws = 56/2/14 = 2 merged tokens per side
            "fullatt_block_indexes": [1],
        },
    }
    cfg.update(overrides)
    return cfg


def qwen2_5_vl_7b_config() -> dict:
    """Qwen/Qwen2.5-VL-7B-Instruct's published widths (config.json): the
    text model is Qwen2-VL-7B's."""
    return tiny_qwen2_5_vl_config(
        hidden_size=3584,
        num_hidden_layers=28,
        intermediate_size=18944,
        num_attention_heads=28,
        num_key_value_heads=4,
        vocab_size=152064,
        rope_theta=1000000.0,
        rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
        max_position_embeddings=128000,
        image_token_id=151655,
        video_token_id=151656,
        vision_start_token_id=151652,
        vision_config={
            "depth": 32,
            "hidden_size": 1280,
            "intermediate_size": 3420,
            "out_hidden_size": 3584,
            "num_heads": 16,
            "patch_size": 14,
            "in_channels": 3,
            "spatial_merge_size": 2,
            "temporal_patch_size": 2,
            "tokens_per_second": 2,
            "window_size": 112,
            "fullatt_block_indexes": [7, 15, 23, 31],
        },
    )


def _qwen2_5_vl_vision_specs(config: dict) -> list:
    vc = config["vision_config"]
    E = vc["hidden_size"]
    I = vc["intermediate_size"]
    P = vc.get("patch_size", 14)
    T = vc.get("temporal_patch_size", 2)
    C = vc.get("in_channels", 3)
    m = vc.get("spatial_merge_size", 2)
    out_d = vc["out_hidden_size"]
    specs = [("visual.patch_embed.proj.weight", (E, C, T, P, P), "rand")]
    for i in range(vc["depth"]):
        p = f"visual.blocks.{i}."
        specs += [
            (p + "norm1.weight", (E,), "ones"),
            (p + "norm2.weight", (E,), "ones"),
            (p + "attn.qkv.weight", (3 * E, E), "rand"),
            (p + "attn.qkv.bias", (3 * E,), "rand"),
            (p + "attn.proj.weight", (E, E), "rand"),
            (p + "attn.proj.bias", (E,), "rand"),
            (p + "mlp.gate_proj.weight", (I, E), "rand"),
            (p + "mlp.gate_proj.bias", (I,), "rand"),
            (p + "mlp.up_proj.weight", (I, E), "rand"),
            (p + "mlp.up_proj.bias", (I,), "rand"),
            (p + "mlp.down_proj.weight", (E, I), "rand"),
            (p + "mlp.down_proj.bias", (E,), "rand"),
        ]
    hidden_m = E * m * m
    specs += [
        ("visual.merger.ln_q.weight", (E,), "ones"),
        ("visual.merger.mlp.0.weight", (hidden_m, hidden_m), "rand"),
        ("visual.merger.mlp.0.bias", (hidden_m,), "rand"),
        ("visual.merger.mlp.2.weight", (out_d, hidden_m), "rand"),
        ("visual.merger.mlp.2.bias", (out_d,), "rand"),
    ]
    return specs


def qwen2_5_vl_hf_weights(config: dict, seed: int = 0,
                          scale: float = 0.05) -> dict:
    """Random f32 weights with HF qwen2.5-vl checkpoint keys; the same
    arrays as the reference's builder for a seed (its language part is
    qwen2_vl_hf_weights' with a tiny Qwen2-VL vision config swapped in,
    the vision tower drawn from a fresh generator of the same seed)."""
    lang_cfg = dict(config)
    lang_cfg["vision_config"] = tiny_qwen2_vl_config()["vision_config"]
    w = {k: v for k, v in qwen2_vl_hf_weights(lang_cfg, seed, scale).items()
         if not k.startswith("visual.")}
    w.update(_draw(_qwen2_5_vl_vision_specs(config),
                   np.random.default_rng(seed), scale))
    return w


def tiny_qwen3_vl_config(**overrides) -> dict:
    cfg = {
        "model_type": "qwen3_vl",
        "image_token_id": 64,
        "video_token_id": 65,
        "vision_start_token_id": 66,
        "text_config": {
            "model_type": "qwen3_vl_text",
            "hidden_size": 48,
            "num_hidden_layers": 4,
            "intermediate_size": 96,
            "num_attention_heads": 4,
            "num_key_value_heads": 2,
            "head_dim": 16,
            "rms_norm_eps": 1e-6,
            "vocab_size": 256,
            "rope_theta": 10000.0,
            "max_position_embeddings": 1024,
            "rope_scaling": {"type": "default", "mrope_section": [4, 2, 2]},
        },
        "vision_config": {
            "model_type": "qwen3_vl",
            "depth": 3,
            "hidden_size": 32,
            "intermediate_size": 64,
            "out_hidden_size": 48,
            "num_heads": 4,
            "patch_size": 14,
            "temporal_patch_size": 2,
            "spatial_merge_size": 2,
            "num_position_embeddings": 16,
            "deepstack_visual_indexes": [0, 1],
        },
    }
    cfg.update(overrides)
    return cfg


def qwen3_vl_8b_config() -> dict:
    """Qwen/Qwen3-VL-8B-Instruct's published widths (config.json)."""
    return tiny_qwen3_vl_config(
        image_token_id=151655,
        video_token_id=151656,
        vision_start_token_id=151652,
        vision_end_token_id=151653,
        tie_word_embeddings=False,
        text_config={
            "model_type": "qwen3_vl_text",
            "hidden_size": 4096,
            "num_hidden_layers": 36,
            "intermediate_size": 12288,
            "num_attention_heads": 32,
            "num_key_value_heads": 8,
            "head_dim": 128,
            "rms_norm_eps": 1e-6,
            "vocab_size": 151936,
            "rope_theta": 5000000.0,
            "max_position_embeddings": 262144,
            "tie_word_embeddings": False,
            "attention_bias": False,
            "rope_scaling": {"rope_type": "default", "mrope_interleaved": True,
                             "mrope_section": [24, 20, 20]},
        },
        vision_config={
            "model_type": "qwen3_vl",
            "depth": 27,
            "hidden_size": 1152,
            "intermediate_size": 4304,
            "out_hidden_size": 4096,
            "num_heads": 16,
            "patch_size": 16,
            "in_channels": 3,
            "temporal_patch_size": 2,
            "spatial_merge_size": 2,
            "num_position_embeddings": 2304,
            "deepstack_visual_indexes": [8, 16, 24],
            "hidden_act": "gelu_pytorch_tanh",
        },
    )


def qwen3_vl_tensor_specs(config: dict) -> list:
    """(HF key, shape, fill) of every tensor of a Qwen3-VL checkpoint
    (model.language_model.*, model.visual.*, lm_head), in the draw order of
    the JAX package's test builder."""
    tc, vc = config["text_config"], config["vision_config"]
    D, V, I = tc["hidden_size"], tc["vocab_size"], tc["intermediate_size"]
    nh, nkv, hd = (tc["num_attention_heads"], tc["num_key_value_heads"],
                   tc["head_dim"])
    specs = [("model.language_model.embed_tokens.weight", (V, D), "rand"),
             ("model.language_model.norm.weight", (D,), "ones")]
    if not tc.get("tie_word_embeddings"):
        specs.append(("lm_head.weight", (V, D), "rand"))
    for i in range(tc["num_hidden_layers"]):
        p = f"model.language_model.layers.{i}."
        specs += [
            (p + "input_layernorm.weight", (D,), "ones"),
            (p + "post_attention_layernorm.weight", (D,), "ones"),
            (p + "self_attn.q_proj.weight", (nh * hd, D), "rand"),
            (p + "self_attn.k_proj.weight", (nkv * hd, D), "rand"),
            (p + "self_attn.v_proj.weight", (nkv * hd, D), "rand"),
            (p + "self_attn.o_proj.weight", (D, nh * hd), "rand"),
            (p + "self_attn.q_norm.weight", (hd,), "ones"),
            (p + "self_attn.k_norm.weight", (hd,), "ones"),
            (p + "mlp.gate_proj.weight", (I, D), "rand"),
            (p + "mlp.up_proj.weight", (I, D), "rand"),
            (p + "mlp.down_proj.weight", (D, I), "rand"),
        ]
    E = vc["hidden_size"]
    P, T, C = vc["patch_size"], vc["temporal_patch_size"], 3
    Iv = vc["intermediate_size"]
    mu = vc["spatial_merge_size"] ** 2
    out_d = vc["out_hidden_size"]
    p = "model.visual."
    specs += [(p + "patch_embed.proj.weight", (E, C, T, P, P), "rand"),
              (p + "patch_embed.proj.bias", (E,), "rand"),
              (p + "pos_embed.weight", (vc["num_position_embeddings"], E),
               "rand")]
    for i in range(vc["depth"]):
        q = p + f"blocks.{i}."
        for nm in ("norm1", "norm2"):
            specs += [(q + nm + ".weight", (E,), "ones"),
                      (q + nm + ".bias", (E,), "zeros")]
        specs += [
            (q + "attn.qkv.weight", (3 * E, E), "rand"),
            (q + "attn.qkv.bias", (3 * E,), "rand"),
            (q + "attn.proj.weight", (E, E), "rand"),
            (q + "attn.proj.bias", (E,), "rand"),
            (q + "mlp.linear_fc1.weight", (Iv, E), "rand"),
            (q + "mlp.linear_fc1.bias", (Iv,), "rand"),
            (q + "mlp.linear_fc2.weight", (E, Iv), "rand"),
            (q + "mlp.linear_fc2.bias", (E,), "rand"),
        ]
    mergers = [p + "merger."] + [
        p + f"deepstack_merger_list.{j}."
        for j in range(len(vc["deepstack_visual_indexes"]))]
    for q in mergers:
        n = mu * E if "deepstack" in q else E
        specs += [
            (q + "norm.weight", (n,), "ones"),
            (q + "norm.bias", (n,), "zeros"),
            (q + "linear_fc1.weight", (mu * E, mu * E), "rand"),
            (q + "linear_fc1.bias", (mu * E,), "rand"),
            (q + "linear_fc2.weight", (out_d, mu * E), "rand"),
            (q + "linear_fc2.bias", (out_d,), "rand"),
        ]
    return specs


def qwen3_vl_hf_weights(config: dict, seed: int = 0,
                        scale: float = 0.05) -> dict:
    """Random f32 weights with HF qwen3-vl checkpoint keys; the same arrays
    as the JAX package's test builder (tests/test_qwen3_vl.py:55) for a
    seed."""
    return _draw(qwen3_vl_tensor_specs(config), np.random.default_rng(seed),
                 scale)


def tiny_qwen3_vl_moe_config(**overrides) -> dict:
    """The JAX package's Qwen3-VL-MoE test model (tests/test_qwen3_vl_moe.py
    `tiny_moe_config`): the tiny Qwen3-VL with 4 experts of width 32, 2 a
    token."""
    cfg = tiny_qwen3_vl_config(model_type="qwen3_vl_moe")
    cfg["text_config"].update(
        model_type="qwen3_vl_moe_text", num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=32, norm_topk_prob=True)
    cfg.update(overrides)
    return cfg


def qwen3_vl_moe_30b_a3b_config() -> dict:
    """Qwen/Qwen3-VL-30B-A3B-Instruct's published widths (config.json):
    Qwen3-VL-8B's tower with out_hidden_size 2048, and a 48-layer MoE
    decoder of hidden 2048, 32 / 4 heads of 128, 128 experts of width 768,
    8 a token."""
    cfg = qwen3_vl_8b_config()
    cfg["model_type"] = "qwen3_vl_moe"
    cfg["text_config"] = {
        "model_type": "qwen3_vl_moe_text",
        "hidden_size": 2048,
        "num_hidden_layers": 48,
        "intermediate_size": 6144,
        "num_attention_heads": 32,
        "num_key_value_heads": 4,
        "head_dim": 128,
        "rms_norm_eps": 1e-6,
        "vocab_size": 151936,
        "rope_theta": 5000000.0,
        "max_position_embeddings": 262144,
        "tie_word_embeddings": False,
        "attention_bias": False,
        "rope_scaling": {"rope_type": "default", "mrope_interleaved": True,
                         "mrope_section": [24, 20, 20]},
        "num_experts": 128,
        "num_experts_per_tok": 8,
        "moe_intermediate_size": 768,
        "norm_topk_prob": True,
        "decoder_sparse_step": 1,
        "mlp_only_layers": [],
    }
    cfg["vision_config"] = dict(cfg["vision_config"], out_hidden_size=2048)
    return cfg


def qwen3_vl_moe_tensor_specs(config: dict) -> list:
    """(HF key, shape, fill) of every tensor of a Qwen3-VL-MoE checkpoint in
    the mlx conversions' fused layout: Qwen3-VL's, each layer's dense MLP
    replaced by its router `mlp.gate` [E, D] and the expert stacks
    `mlp.switch_mlp.{gate,up}_proj` [E, I, D] and `down_proj` [E, D, I]."""
    tc = config["text_config"]
    D, E, I = tc["hidden_size"], tc["num_experts"], tc["moe_intermediate_size"]
    specs = []
    for key, shape, fill in qwen3_vl_tensor_specs(config):
        if key.endswith((".mlp.up_proj.weight", ".mlp.down_proj.weight")):
            continue
        if key.endswith(".mlp.gate_proj.weight"):
            p = key[: -len("gate_proj.weight")]
            specs += [(p + "gate.weight", (E, D), "rand"),
                      (p + "switch_mlp.gate_proj.weight", (E, I, D), "rand"),
                      (p + "switch_mlp.up_proj.weight", (E, I, D), "rand"),
                      (p + "switch_mlp.down_proj.weight", (E, D, I), "rand")]
            continue
        specs.append((key, shape, fill))
    return specs


def qwen3_vl_moe_hf_weights(config: dict, seed: int = 0,
                            layout: str = "hf") -> dict:
    """Random f32 weights of a Qwen3-VL-MoE checkpoint; the same arrays as
    the JAX package's test weights (tests/test_qwen3_vl_moe.py
    `tiny_moe_weights`) for a seed: Qwen3-VL's weights without the dense
    MLPs, then from a second generator of the seed each layer's router,
    gate, up and down, fused as HF writes them (`layout="hf"`:
    `experts.gate_up_proj` [E, D, 2I], `experts.down_proj` [E, I, D]) or as
    the mlx conversions do (`"mlx"`: `switch_mlp.*` [E, I, D] / [E, D,
    I])."""
    rng = np.random.default_rng(seed)
    w = qwen3_vl_hf_weights(config, seed)
    tc = config["text_config"]
    D, E, I = tc["hidden_size"], tc["num_experts"], tc["moe_intermediate_size"]

    def rand(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    for i in range(tc["num_hidden_layers"]):
        p = f"model.language_model.layers.{i}.mlp."
        for nm in ("gate_proj", "up_proj", "down_proj"):
            w.pop(p + nm + ".weight")
        w[p + "gate.weight"] = rand(E, D)
        gate, up, down = rand(E, I, D), rand(E, I, D), rand(E, D, I)
        if layout == "hf":
            w[p + "experts.gate_up_proj"] = np.concatenate(
                [gate.transpose(0, 2, 1), up.transpose(0, 2, 1)], axis=-1)
            w[p + "experts.down_proj"] = down.transpose(0, 2, 1)
        else:
            w[p + "switch_mlp.gate_proj"] = gate
            w[p + "switch_mlp.up_proj"] = up
            w[p + "switch_mlp.down_proj"] = down
    return w


def tiny_llama_config(**overrides) -> dict:
    cfg = {
        "model_type": "llama",
        "hidden_size": 64,
        "num_hidden_layers": 2,
        "intermediate_size": 128,
        "num_attention_heads": 4,
        "num_key_value_heads": 2,
        "rms_norm_eps": 1e-5,
        "vocab_size": 256,
        "rope_theta": 10000.0,
        "tie_word_embeddings": False,
        "max_position_embeddings": 1024,
    }
    cfg.update(overrides)
    return cfg


def llama_3_1_8b_config() -> dict:
    """meta-llama/Llama-3.1-8B-Instruct's published widths (config.json):
    hidden 4096, 32 layers, 32 / 8 heads of 128, intermediate 14336, vocab
    128256, rope theta 500000 with its llama3 scaling, untied head."""
    return tiny_llama_config(
        hidden_size=4096,
        num_hidden_layers=32,
        intermediate_size=14336,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=128,
        rms_norm_eps=1e-5,
        vocab_size=128256,
        rope_theta=500000.0,
        rope_scaling={"factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192,
                      "rope_type": "llama3"},
        tie_word_embeddings=False,
        max_position_embeddings=131072,
        attention_bias=False,
        mlp_bias=False,
        bos_token_id=128000,
        eos_token_id=[128001, 128008, 128009],
    )


def llama_tensor_specs(config: dict) -> list:
    """(HF key, shape, fill) of every tensor of a llama checkpoint, in the
    JAX package's builder's draw order (its llama_hf_weights)."""
    D, V, I = (config["hidden_size"], config["vocab_size"],
               config["intermediate_size"])
    nh = config["num_attention_heads"]
    nkv = config.get("num_key_value_heads") or nh
    hd = config.get("head_dim") or D // nh
    specs = [("model.embed_tokens.weight", (V, D), "rand"),
             ("model.norm.weight", (D,), "ones")]
    for i in range(config["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs += [
            (p + "input_layernorm.weight", (D,), "ones"),
            (p + "post_attention_layernorm.weight", (D,), "ones"),
            (p + "self_attn.q_proj.weight", (nh * hd, D), "rand"),
            (p + "self_attn.k_proj.weight", (nkv * hd, D), "rand"),
            (p + "self_attn.v_proj.weight", (nkv * hd, D), "rand"),
            (p + "self_attn.o_proj.weight", (D, nh * hd), "rand"),
            (p + "mlp.gate_proj.weight", (I, D), "rand"),
            (p + "mlp.up_proj.weight", (I, D), "rand"),
            (p + "mlp.down_proj.weight", (D, I), "rand"),
        ]
    if not config.get("tie_word_embeddings"):
        specs.append(("lm_head.weight", (V, D), "rand"))
    return specs


def llama_hf_weights(config: dict, seed: int = 0,
                     scale: float = 0.05) -> dict:
    """Random f32 weights with HF llama checkpoint keys; the same arrays as
    the JAX package's builder for a seed."""
    return _draw(llama_tensor_specs(config), np.random.default_rng(seed),
                 scale)


def tiny_llava_config(**overrides) -> dict:
    cfg = {
        "model_type": "llava",
        "image_token_index": 32,
        "vision_feature_layer": -2,
        "vision_feature_select_strategy": "default",
        "vocab_size": 256,
        "text_config": tiny_llama_config(),
        "vision_config": {
            "model_type": "clip_vision_model",
            "num_hidden_layers": 2,
            "hidden_size": 32,
            "intermediate_size": 64,
            "num_attention_heads": 4,
            "image_size": 28,
            "patch_size": 14,
            "num_channels": 3,
        },
    }
    cfg.update(overrides)
    return cfg


def llava_1_5_7b_config() -> dict:
    """llava-hf/llava-1.5-7b-hf's published widths (config.json, its
    text_config resolved to Llama-2-7B's): a 32-layer decoder of hidden
    4096, 32 / 32 heads, intermediate 11008, vocab 32064, rope theta 10000,
    4096 positions; the CLIP ViT-L/14-336 tower (24 layers, hidden 1024, 16
    heads, intermediate 4096, quick-GELU); image token 32000, a GELU
    projector."""
    return tiny_llava_config(
        image_token_index=32000,
        vocab_size=32064,
        pad_token_id=32001,
        projector_hidden_act="gelu",
        tie_word_embeddings=False,
        text_config={
            "model_type": "llama",
            "hidden_size": 4096,
            "num_hidden_layers": 32,
            "intermediate_size": 11008,
            "num_attention_heads": 32,
            "num_key_value_heads": 32,
            "head_dim": 128,
            "rms_norm_eps": 1e-5,
            "vocab_size": 32064,
            "rope_theta": 10000.0,
            "max_position_embeddings": 4096,
            "tie_word_embeddings": False,
            "eos_token_id": 2,
        },
        vision_config={
            "model_type": "clip_vision_model",
            "num_hidden_layers": 24,
            "hidden_size": 1024,
            "intermediate_size": 4096,
            "num_attention_heads": 16,
            "image_size": 336,
            "patch_size": 14,
            "projection_dim": 768,
            "vocab_size": 32000,
            "num_channels": 3,
            "layer_norm_eps": 1e-5,
            "hidden_act": "quick_gelu",
        },
    )


def llava_vision_specs(config: dict) -> list:
    """(HF key, shape, fill) of a LLaVA checkpoint's CLIP tower and
    projector, in the JAX package's builder's draw order."""
    vc, D = config["vision_config"], config["text_config"]["hidden_size"]
    E, P, I = vc["hidden_size"], vc["patch_size"], vc["intermediate_size"]
    C = vc.get("num_channels", 3)
    p = "vision_tower.vision_model."
    specs = [(p + "embeddings.class_embedding", (E,), "rand"),
             (p + "embeddings.patch_embedding.weight", (E, C, P, P), "rand"),
             (p + "embeddings.position_embedding.weight",
              ((vc["image_size"] // P) ** 2 + 1, E), "rand")]
    for nm in ("pre_layrnorm", "post_layernorm"):
        specs += [(p + nm + ".weight", (E,), "ones"),
                  (p + nm + ".bias", (E,), "zeros")]
    for i in range(vc["num_hidden_layers"]):
        q = p + f"encoder.layers.{i}."
        for nm in ("layer_norm1", "layer_norm2"):
            specs += [(q + nm + ".weight", (E,), "ones"),
                      (q + nm + ".bias", (E,), "zeros")]
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            specs += [(q + f"self_attn.{nm}.weight", (E, E), "rand"),
                      (q + f"self_attn.{nm}.bias", (E,), "rand")]
        specs += [(q + "mlp.fc1.weight", (I, E), "rand"),
                  (q + "mlp.fc1.bias", (I,), "rand"),
                  (q + "mlp.fc2.weight", (E, I), "rand"),
                  (q + "mlp.fc2.bias", (E,), "rand")]
    p = "multi_modal_projector."
    return specs + [(p + "linear_1.weight", (D, E), "rand"),
                    (p + "linear_1.bias", (D,), "rand"),
                    (p + "linear_2.weight", (D, D), "rand"),
                    (p + "linear_2.bias", (D,), "rand")]


def llava_hf_weights(config: dict, seed: int = 0,
                     scale: float = 0.05) -> dict:
    """Random f32 weights with HF LLaVA checkpoint keys; the same arrays
    as the JAX package's builder for a seed (the language model's drawn
    by llama_hf_weights, the tower's and projector's from a second
    generator of the seed)."""
    w = {"language_model." + k: v for k, v in
         llama_hf_weights(config["text_config"], seed, scale).items()}
    w.update(_draw(llava_vision_specs(config), np.random.default_rng(seed),
                   scale))
    return w


# ------------------------------------------------------------ PaliGemma


def tiny_paligemma_config(gemma2: bool = False, **overrides) -> dict:
    text = {
        "model_type": "gemma2" if gemma2 else "gemma",
        "hidden_size": 48,
        "num_hidden_layers": 4,
        "intermediate_size": 96,
        "num_attention_heads": 4,
        "num_key_value_heads": 2,
        "vocab_size": 256,
        "rms_norm_eps": 1e-6,
    }
    if gemma2:
        text.update(
            head_dim=16,
            query_pre_attn_scalar=16.0,
            attn_logit_softcapping=50.0,
            final_logit_softcapping=30.0,
            sliding_window=4,
        )
    cfg = {
        "model_type": "paligemma",
        "image_token_index": 64,
        "hidden_size": 48,
        "pad_token_id": 0,
        "projection_dim": 48,
        "text_config": text,
        "vision_config": {
            "model_type": "siglip_vision_model",
            "num_hidden_layers": 2,
            "hidden_size": 32,
            "intermediate_size": 64,
            "num_attention_heads": 4,
            "image_size": 28,  # 2x2 patches
            "patch_size": 14,
            "num_channels": 3,
            "projection_dim": 48,
        },
    }
    cfg.update(overrides)
    return cfg


def tiny_gemma_text_config(gemma2: bool = False, **overrides) -> dict:
    """The text model of tiny_paligemma_config as a text-only gemma /
    gemma2 checkpoint's config."""
    cfg = dict(tiny_paligemma_config(gemma2)["text_config"])
    cfg.update(overrides)
    return cfg


def paligemma2_3b_224_config() -> dict:
    """google/paligemma2-3b-pt-224's published widths (config.json): a
    Gemma-2-2B decoder (hidden 2304, 26 layers, 8 / 4 heads of 256,
    intermediate 9216, vocab 257216, query_pre_attn_scalar 256, attention
    soft-cap 50, final soft-cap 30, window 4096 on the even layers), the
    SigLIP-So400m/14 tower at 224 (27 layers, hidden 1152, intermediate
    4304, 16 heads: 256 image tokens), projection_dim 2304, image token
    257152 (the root hidden_size is the release's stale 2048)."""
    return {
        "model_type": "paligemma",
        "image_token_index": 257152,
        "hidden_size": 2048,
        "pad_token_id": 0,
        "bos_token_id": 2,
        "eos_token_id": 1,
        "projection_dim": 2304,
        "text_config": {
            "model_type": "gemma2",
            "hidden_size": 2304,
            "num_hidden_layers": 26,
            "intermediate_size": 9216,
            "num_attention_heads": 8,
            "num_key_value_heads": 4,
            "head_dim": 256,
            "vocab_size": 257216,
            "rms_norm_eps": 1e-6,
            "rope_theta": 10000.0,
            "query_pre_attn_scalar": 256,
            "attn_logit_softcapping": 50.0,
            "final_logit_softcapping": 30.0,
            "sliding_window": 4096,
            "hidden_activation": "gelu_pytorch_tanh",
        },
        "vision_config": _so400m_224(2304),
    }


def paligemma_3b_224_config() -> dict:
    """google/paligemma-3b-pt-224's published widths (config.json): a
    Gemma-2B decoder (hidden 2048, 18 layers, 8 heads over 1 KV head of
    256, intermediate 16384, vocab 257216), the same SigLIP tower,
    projection_dim 2048, image token 257152."""
    return {
        "model_type": "paligemma",
        "image_token_index": 257152,
        "hidden_size": 2048,
        "pad_token_id": 0,
        "bos_token_id": 2,
        "eos_token_id": 1,
        "projection_dim": 2048,
        "text_config": {
            "model_type": "gemma",
            "hidden_size": 2048,
            "num_hidden_layers": 18,
            "intermediate_size": 16384,
            "num_attention_heads": 8,
            "num_key_value_heads": 1,
            "vocab_size": 257216,
            "rms_norm_eps": 1e-6,
            "rope_theta": 10000.0,
            "hidden_activation": "gelu_pytorch_tanh",
        },
        "vision_config": _so400m_224(2048),
    }


def _so400m_224(projection_dim: int) -> dict:
    return {
        "model_type": "siglip_vision_model",
        "num_hidden_layers": 27,
        "hidden_size": 1152,
        "intermediate_size": 4304,
        "num_attention_heads": 16,
        "image_size": 224,
        "patch_size": 14,
        "num_channels": 3,
        "projection_dim": projection_dim,
        "layer_norm_eps": 1e-6,
    }


def gemma_text_tensor_specs(config: dict) -> list:
    """(HF key, shape, fill) of every tensor of a gemma / gemma2 text
    checkpoint, in the JAX package's builder's draw order (the language
    model of its paligemma_hf_weights; the norms stored as w - 1, zeros)."""
    gemma2 = config["model_type"] == "gemma2"
    D, I = config["hidden_size"], config["intermediate_size"]
    nh, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim", D // nh) if gemma2 else D // nh
    specs = [("model.embed_tokens.weight", (config["vocab_size"], D), "rand"),
             ("model.norm.weight", (D,), "zeros")]
    norms = ["input_layernorm", "post_attention_layernorm"]
    if gemma2:
        norms += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
    for i in range(config["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs += [(p + nm + ".weight", (D,), "zeros") for nm in norms]
        specs += [
            (p + "self_attn.q_proj.weight", (nh * hd, D), "rand"),
            (p + "self_attn.k_proj.weight", (nkv * hd, D), "rand"),
            (p + "self_attn.v_proj.weight", (nkv * hd, D), "rand"),
            (p + "self_attn.o_proj.weight", (D, nh * hd), "rand"),
            (p + "mlp.gate_proj.weight", (I, D), "rand"),
            (p + "mlp.up_proj.weight", (I, D), "rand"),
            (p + "mlp.down_proj.weight", (D, I), "rand"),
        ]
    return specs


def siglip_vision_specs(config: dict) -> list:
    """(HF key, shape, fill) of a PaliGemma checkpoint's SigLIP tower and
    projector, in the JAX package's builder's draw order."""
    vc, D = config["vision_config"], config["text_config"]["hidden_size"]
    E, P, I = vc["hidden_size"], vc["patch_size"], vc["intermediate_size"]
    C = vc.get("num_channels", 3)
    p = "vision_tower.vision_model."
    specs = [(p + "embeddings.patch_embedding.weight", (E, C, P, P), "rand"),
             (p + "embeddings.patch_embedding.bias", (E,), "rand"),
             (p + "embeddings.position_embedding.weight",
              ((vc["image_size"] // P) ** 2, E), "rand"),
             (p + "post_layernorm.weight", (E,), "ones"),
             (p + "post_layernorm.bias", (E,), "zeros")]
    for i in range(vc["num_hidden_layers"]):
        q = p + f"encoder.layers.{i}."
        for nm in ("layer_norm1", "layer_norm2"):
            specs += [(q + nm + ".weight", (E,), "ones"),
                      (q + nm + ".bias", (E,), "zeros")]
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            specs += [(q + f"self_attn.{nm}.weight", (E, E), "rand"),
                      (q + f"self_attn.{nm}.bias", (E,), "rand")]
        specs += [(q + "mlp.fc1.weight", (I, E), "rand"),
                  (q + "mlp.fc1.bias", (I,), "rand"),
                  (q + "mlp.fc2.weight", (E, I), "rand"),
                  (q + "mlp.fc2.bias", (E,), "rand")]
    return specs + [("multi_modal_projector.linear.weight", (D, E), "rand"),
                    ("multi_modal_projector.linear.bias", (D,), "rand")]


def paligemma_tensor_specs(config: dict) -> list:
    """(HF key, shape, fill) of every tensor of a PaliGemma checkpoint."""
    return ([("language_model." + k, shape, fill) for k, shape, fill
             in gemma_text_tensor_specs(config["text_config"])]
            + siglip_vision_specs(config))


def paligemma_hf_weights(config: dict, seed: int = 0,
                         scale: float = 0.05) -> dict:
    """Random f32 weights with HF PaliGemma checkpoint keys; the same
    arrays as the JAX package's builder for a seed (one generator, the
    language model first)."""
    return _draw(paligemma_tensor_specs(config), np.random.default_rng(seed),
                 scale)


def gemma_text_hf_weights(config: dict, seed: int = 0,
                          scale: float = 0.05) -> dict:
    """Random f32 weights of a text-only gemma / gemma2 checkpoint: the
    language model of paligemma_hf_weights for a seed, under its own
    keys."""
    return _draw(gemma_text_tensor_specs(config), np.random.default_rng(seed),
                 scale)


# ------------------------------------------------------------ text MoE

# the text MoE decoders' model types (qwen3_moe loads as qwen2_moe)
MOE_TEXT_TYPES = ("qwen2_moe", "qwen3_moe", "mixtral", "olmoe", "phimoe",
                  "granitemoe")
# special tokens at their public ids for the families whose vocabularies
# do not hold Qwen's (ByteTokenizer's arguments: tokens, EOS, pad):
# Mixtral's (Llama-2's), OLMoE's (GPT-NeoX's), Phi-3.5-MoE's (Phi-3's) and
# Granite 3.0's
MOE_TEXT_SPECIAL_TOKENS = {
    "mixtral": ({"<unk>": 0, "<s>": 1, "</s>": 2}, "</s>", "<unk>"),
    "olmoe": ({"<|padding|>": 1, "<|endoftext|>": 50279}, "<|endoftext|>",
              "<|padding|>"),
    "phimoe": ({"<unk>": 0, "<s>": 1, "</s>": 2, "<|endoftext|>": 32000,
                "<|assistant|>": 32001, "<|end|>": 32007, "<|user|>": 32010},
               "<|end|>", "<|endoftext|>"),
    "granitemoe": ({"<|end_of_text|>": 0, "<|start_of_role|>": 49152,
                    "<|end_of_role|>": 49153, "<|tool_call|>": 49154},
                   "<|end_of_text|>", "<|end_of_text|>"),
}


def tiny_qwen2_moe_config(**overrides) -> dict:
    """The JAX package's Qwen-MoE test model (mlx_vlm_tpu/utils/testing.py
    `tiny_qwen2_moe_config`): the tiny llama with 4 experts of width 32, 2
    a token, and a shared expert of 64."""
    cfg = tiny_llama_config(
        model_type="qwen2_moe",
        num_experts=4,
        num_experts_per_tok=2,
        moe_intermediate_size=32,
        shared_expert_intermediate_size=64,
        norm_topk_prob=False,
    )
    cfg.update(overrides)
    return cfg


def qwen2_moe_hf_weights(config: dict, seed: int = 0,
                         scale: float = 0.05) -> dict:
    """Random f32 Qwen-MoE weights with HF keys; the same arrays as the JAX
    package's `qwen2_moe_hf_weights` for a seed: llama_hf_weights' arrays
    without the dense MLPs, then from a second generator of the seed each
    layer's router, experts (one key each) and shared expert with its
    gate."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    D = config["hidden_size"]
    E = config["num_experts"]
    Im = config["moe_intermediate_size"]
    Is = config["shared_expert_intermediate_size"]
    w = llama_hf_weights(config, seed, scale)
    for i in range(config["num_hidden_layers"]):
        p = f"model.layers.{i}.mlp."
        for nm in ("gate_proj", "up_proj", "down_proj"):
            del w[p + nm + ".weight"]
        w[p + "gate.weight"] = rand(E, D)
        for e in range(E):
            w[p + f"experts.{e}.gate_proj.weight"] = rand(Im, D)
            w[p + f"experts.{e}.up_proj.weight"] = rand(Im, D)
            w[p + f"experts.{e}.down_proj.weight"] = rand(D, Im)
        w[p + "shared_expert.gate_proj.weight"] = rand(Is, D)
        w[p + "shared_expert.up_proj.weight"] = rand(Is, D)
        w[p + "shared_expert.down_proj.weight"] = rand(D, Is)
        w[p + "shared_expert_gate.weight"] = rand(1, D)
    return w


def tiny_moe_text_config(model_type: str, **overrides) -> dict:
    """A tiny config of one of MOE_TEXT_TYPES on the Qwen-MoE test model:
    qwen2_moe as it is (shared expert, q / k / v biases in its weights);
    qwen3_moe with renormalised routing, no shared expert and per-head q /
    k norms of a head dim of its own (24); mixtral; olmoe (flat q / k
    norms); phimoe (LayerNorms with biases, biased attention and head, a
    longrope scaling whose long factors apply past 16 positions); and
    granitemoe (Granite 3.0's multipliers, the attention one 1 / head_dim,
    a tied head)."""
    E = 4
    over = {
        "qwen2_moe": {},
        "qwen3_moe": {"norm_topk_prob": True, "head_dim": 24,
                      "attention_bias": False},
        "mixtral": {"num_local_experts": E, "norm_topk_prob": True,
                    "attention_bias": False},
        "olmoe": {"attention_bias": False},
        "phimoe": {
            "num_local_experts": E, "norm_topk_prob": True,
            "attention_bias": True, "max_position_embeddings": 64,
            "original_max_position_embeddings": 16,
            "rope_scaling": {"type": "longrope", "short_factor": [1.0] * 8,
                             "long_factor": [1.0 + 0.25 * j
                                             for j in range(8)],
                             "short_mscale": 1.0, "long_mscale": 1.2}},
        "granitemoe": {"num_local_experts": E, "norm_topk_prob": True,
                       "attention_bias": False, "tie_word_embeddings": True,
                       "embedding_multiplier": 12.0,
                       "residual_multiplier": 0.22,
                       "attention_multiplier": 1 / 16,
                       "logits_scaling": 6.0},
    }[model_type]
    cfg = tiny_qwen2_moe_config(model_type=model_type, num_experts=E, **over)
    cfg.update(overrides)
    return cfg


def _moe_block(model_type: str) -> tuple:
    """(the MoE block's prefix in a layer, its router's name) in the
    checkpoints of `model_type`."""
    if model_type in ("mixtral", "phimoe"):
        return "block_sparse_moe.", "gate"
    if model_type == "granitemoe":
        return "block_sparse_moe.", "router.layer"
    return "mlp.", "gate"


def _moe_extras(config: dict) -> list:
    """(key suffix in a layer, shape, fill) of the attention and norm
    tensors a family adds to the llama layer: qwen2_moe's q / k / v biases
    (where `attention_bias`), phimoe's q / k / v / o biases and LayerNorm
    biases, qwen3_moe's per-head and olmoe's flat q / k norms."""
    kind = config["model_type"]
    D, nh = config["hidden_size"], config["num_attention_heads"]
    nkv = config.get("num_key_value_heads") or nh
    hd = config.get("head_dim") or D // nh
    out = []
    if kind in ("qwen2_moe", "phimoe") and config.get("attention_bias", True):
        out += [(f"self_attn.{nm}.bias", (n,), "rand") for nm, n in (
            ("q_proj", nh * hd), ("k_proj", nkv * hd), ("v_proj", nkv * hd))]
        if kind == "phimoe":
            out.append(("self_attn.o_proj.bias", (D,), "rand"))
    if kind == "qwen3_moe":
        out += [("self_attn.q_norm.weight", (hd,), "ones"),
                ("self_attn.k_norm.weight", (hd,), "ones")]
    if kind == "olmoe":
        out += [("self_attn.q_norm.weight", (nh * hd,), "ones"),
                ("self_attn.k_norm.weight", (nkv * hd,), "ones")]
    if kind == "phimoe":
        out += [(nm + ".bias", (D,), "zeros")
                for nm in ("input_layernorm", "post_attention_layernorm")]
    return out


def moe_text_hf_weights(config: dict, seed: int = 0, scale: float = 0.05,
                        layout: str = "hf") -> dict:
    """Random f32 weights of a MOE_TEXT_TYPES checkpoint: qwen2_moe_hf_weights'
    arrays for the seed (the shared expert kept for qwen2_moe alone), then
    from a generator of seed + 1 the family's extras (`_moe_extras`, each
    rand ~ N(0, scale), each norm 1 + 0.1 N(0, 1), each LayerNorm bias
    ~ N(0, scale); phimoe's model.norm bias and head bias last), in
    `layout` "hf" (the family's HF keys: one key per expert, mixtral's and
    phimoe's `block_sparse_moe.experts.{e}.w1|w3|w2`, granitemoe's fused
    `input_linear` / `output_linear`) or "mlx" (mlx conversions' stacks,
    `switch_mlp.{gate,up,down}_proj` [E, I, D] / [E, D, I] under the
    family's block)."""
    kind = config["model_type"]
    E = config.get("num_experts") or config["num_local_experts"]
    base = dict(config, num_experts=E)
    w = qwen2_moe_hf_weights(base, seed, scale)
    rng = np.random.default_rng(seed + 1)
    out = {}
    block, router = _moe_block(kind)
    for k, v in w.items():
        m = re.match(r"model\.layers\.(\d+)\.mlp\.(.+)$", k)
        if m is None:
            out[k] = v
            continue
        i, rest = int(m.group(1)), m.group(2)
        p = f"model.layers.{i}."
        if rest.startswith("shared_expert"):
            if kind == "qwen2_moe":
                out[k] = v
            continue
        if rest == "gate.weight":
            for suffix, shape, fill in _moe_extras(config):
                out[p + suffix] = (
                    (rng.standard_normal(shape) * scale)
                    if fill in ("rand", "zeros") else
                    1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
            out[p + block + router + ".weight"] = v
            experts = {nm: np.stack([w[p + f"mlp.experts.{e}.{nm}.weight"]
                                     for e in range(E)])
                       for nm in ("gate_proj", "up_proj", "down_proj")}
            if layout == "mlx":
                for nm, a in experts.items():
                    out[p + block + f"switch_mlp.{nm}.weight"] = a
            elif kind == "granitemoe":
                out[p + block + "input_linear.weight"] = np.concatenate(
                    [experts["gate_proj"], experts["up_proj"]], axis=1)
                out[p + block + "output_linear.weight"] = experts["down_proj"]
            else:
                names = ({"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
                         if block == "block_sparse_moe." else
                         {nm: nm for nm in experts})
                for e in range(E):
                    for nm, a in experts.items():
                        out[p + block + f"experts.{e}.{names[nm]}.weight"] = a[e]
    if kind == "phimoe":
        D, V = config["hidden_size"], config["vocab_size"]
        out["model.norm.bias"] = (rng.standard_normal(D) * scale).astype(
            np.float32)
        out["lm_head.bias"] = (rng.standard_normal(V) * scale).astype(
            np.float32)
    return out


def qwen3_30b_a3b_config() -> dict:
    """Qwen/Qwen3-30B-A3B's published widths (config.json): 48 layers of
    hidden 2048, 32 / 4 heads of 128 with per-head q / k norms, 128
    experts of width 768, 8 a token, renormalised; vocab 151936, rope theta
    1e6, an untied head.  Its widths are Qwen3-VL-30B-A3B's language
    model's."""
    return tiny_llama_config(
        model_type="qwen3_moe", hidden_size=2048,
        num_hidden_layers=48, intermediate_size=6144, num_attention_heads=32,
        num_key_value_heads=4, head_dim=128, rms_norm_eps=1e-6,
        vocab_size=151936, rope_theta=1000000.0,
        max_position_embeddings=40960, tie_word_embeddings=False,
        attention_bias=False, num_experts=128, num_experts_per_tok=8,
        moe_intermediate_size=768, norm_topk_prob=True,
        decoder_sparse_step=1, mlp_only_layers=[], bos_token_id=151643,
        eos_token_id=151645)


def qwen1_5_moe_a2_7b_config() -> dict:
    """Qwen/Qwen1.5-MoE-A2.7B's published widths (config.json): 24 layers
    of hidden 2048, 16 / 16 heads of 128, q / k / v biases, 60 experts of
    width 1408, 4 a token, not renormalised, a shared expert of 5632 with
    its sigmoid gate; vocab 151936, rope theta 1e6, an untied head."""
    return tiny_llama_config(
        model_type="qwen2_moe", hidden_size=2048,
        num_hidden_layers=24, intermediate_size=5632, num_attention_heads=16,
        num_key_value_heads=16, rms_norm_eps=1e-6, vocab_size=151936,
        rope_theta=1000000.0, max_position_embeddings=8192,
        tie_word_embeddings=False, num_experts=60, num_experts_per_tok=4,
        moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
        norm_topk_prob=False, decoder_sparse_step=1, bos_token_id=151643,
        eos_token_id=151643)


def mixtral_8x7b_config() -> dict:
    """mistralai/Mixtral-8x7B-v0.1's published widths (config.json): 32
    layers of hidden 4096, 32 / 8 heads of 128, 8 experts of width 14336,
    2 a token; vocab 32000, rope theta 1e6, an untied head."""
    return tiny_llama_config(
        model_type="mixtral", hidden_size=4096,
        num_hidden_layers=32, intermediate_size=14336,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
        vocab_size=32000, rope_theta=1000000.0,
        max_position_embeddings=32768, tie_word_embeddings=False,
        num_local_experts=8, num_experts_per_tok=2, bos_token_id=1,
        eos_token_id=2)


def olmoe_1b_7b_config() -> dict:
    """allenai/OLMoE-1B-7B-0924's published widths (config.json): 16
    layers of hidden 2048, 16 / 16 heads of 128 with flat q / k norms, 64
    experts of width 1024, 8 a token, not renormalised; vocab 50304, rope
    theta 10000, an untied head."""
    return tiny_llama_config(
        model_type="olmoe", hidden_size=2048, num_hidden_layers=16,
        intermediate_size=1024, num_attention_heads=16,
        num_key_value_heads=16, rms_norm_eps=1e-5, vocab_size=50304,
        rope_theta=10000.0, max_position_embeddings=4096,
        tie_word_embeddings=False, num_experts=64, num_experts_per_tok=8,
        norm_topk_prob=False, eos_token_id=50279, pad_token_id=1)


def phi_3_5_moe_config() -> dict:
    """microsoft/Phi-3.5-MoE-instruct's published widths (config.json): 32
    layers of hidden 4096, 32 / 8 heads of 128, LayerNorms, biased q / k /
    v / o and head, 16 experts of width 6400, 2 a token; vocab 32064, rope
    theta 10000 with its longrope scaling (original 4096 positions of
    131072).  The scaling's two lists of 64 per-dimension factors are
    stand-ins here (short 1.0; long rising from 1.0 to 64.0), not the
    release's values; its mscale 1.243 is the release's to 3 places."""
    return tiny_llama_config(
        model_type="phimoe", hidden_size=4096,
        num_hidden_layers=32, intermediate_size=6400,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
        vocab_size=32064, rope_theta=10000.0,
        max_position_embeddings=131072,
        original_max_position_embeddings=4096, tie_word_embeddings=False,
        attention_bias=True, num_local_experts=16, num_experts_per_tok=2,
        rope_scaling={"type": "longrope", "short_factor": [1.0] * 64,
                      "long_factor": [float(64.0 ** (j / 63))
                                      for j in range(64)],
                      "short_mscale": 1.243, "long_mscale": 1.243},
        bos_token_id=1, eos_token_id=32000)


def granite_3_0_3b_a800m_config() -> dict:
    """ibm-granite/granite-3.0-3b-a800m-instruct's published widths
    (config.json): 32 layers of hidden 1536, 24 / 8 heads of 64, 40 experts
    of width 512, 8 a token; multipliers embedding 12.0, residual 0.22,
    attention 0.015625, logits scaling 6.0; vocab 49155, rope theta 10000,
    a tied head."""
    return tiny_llama_config(
        model_type="granitemoe", hidden_size=1536,
        num_hidden_layers=32, intermediate_size=512, num_attention_heads=24,
        num_key_value_heads=8, rms_norm_eps=1e-6, vocab_size=49155,
        rope_theta=10000.0, max_position_embeddings=4096,
        tie_word_embeddings=True, num_local_experts=40,
        num_experts_per_tok=8, embedding_multiplier=12.0,
        residual_multiplier=0.22, attention_multiplier=0.015625,
        logits_scaling=6.0, bos_token_id=0, eos_token_id=0, pad_token_id=0)


def moe_text_tensor_specs(config: dict) -> list:
    """(key, shape, fill) of every tensor of a MOE_TEXT_TYPES checkpoint in
    the mlx conversions' layout: llama_tensor_specs' with each layer's
    dense MLP replaced by its router [E, D] and the `switch_mlp` stacks
    under the family's block (`_moe_block`), qwen2_moe's shared expert and
    its gate [1, D], and the family's extras (`_moe_extras`; phimoe's
    model.norm and head biases)."""
    kind = config["model_type"]
    D = config["hidden_size"]
    E = config.get("num_experts") or config["num_local_experts"]
    I = config["moe_intermediate_size"] if "moe_intermediate_size" in \
        config else config["intermediate_size"]
    Is = config.get("shared_expert_intermediate_size") or 0
    block, router = _moe_block(kind)
    specs = []
    for key, shape, fill in llama_tensor_specs(config):
        if key.endswith((".mlp.up_proj.weight", ".mlp.down_proj.weight")):
            continue
        if key.endswith(".mlp.gate_proj.weight"):
            p = key[: -len("mlp.gate_proj.weight")]
            specs += [(p + suffix, shape, fill)
                      for suffix, shape, fill in _moe_extras(config)]
            specs += [(p + block + router + ".weight", (E, D), "rand"),
                      (p + block + "switch_mlp.gate_proj.weight", (E, I, D),
                       "rand"),
                      (p + block + "switch_mlp.up_proj.weight", (E, I, D),
                       "rand"),
                      (p + block + "switch_mlp.down_proj.weight", (E, D, I),
                       "rand")]
            if kind == "qwen2_moe" and Is:
                specs += [(p + "mlp.shared_expert.gate_proj.weight", (Is, D),
                           "rand"),
                          (p + "mlp.shared_expert.up_proj.weight", (Is, D),
                           "rand"),
                          (p + "mlp.shared_expert.down_proj.weight", (D, Is),
                           "rand"),
                          (p + "mlp.shared_expert_gate.weight", (1, D),
                           "rand")]
            continue
        specs.append((key, shape, fill))
    if kind == "phimoe":
        specs += [("model.norm.bias", (D,), "zeros"),
                  ("lm_head.bias", (config["vocab_size"],), "rand")]
    return specs


def tensor_specs(config: dict, layout: str = "hf") -> list:
    """(HF key, shape, fill) of every tensor of a checkpoint of
    config["model_type"] (qwen2_vl, qwen2_5_vl, qwen3_vl, qwen3_vl_moe,
    the last in the mlx conversions' fused expert layout; llama, llava,
    paligemma, gemma, gemma2 and the text MoE types; gpt_oss and
    CLASSIC_TYPES in `layout`, "hf" or "mlx")."""
    kind = config.get("model_type", "qwen2_vl")
    if kind == "gpt_oss":
        return gpt_oss_tensor_specs(config, layout)
    if kind in CLASSIC_TYPES:
        return classic_tensor_specs(config, layout)
    if kind == "llama":
        return llama_tensor_specs(config)
    if kind == "paligemma":
        return paligemma_tensor_specs(config)
    if kind in ("gemma", "gemma2"):
        return gemma_text_tensor_specs(config)
    if kind == "llava":
        return ([("language_model." + k, shape, fill) for k, shape, fill
                 in llama_tensor_specs(config["text_config"])]
                + llava_vision_specs(config))
    if kind == "qwen2_vl":
        return qwen2_vl_tensor_specs(config)
    if kind == "qwen2_5_vl":
        lang_cfg = dict(config)
        lang_cfg["vision_config"] = tiny_qwen2_vl_config()["vision_config"]
        return ([s for s in qwen2_vl_tensor_specs(lang_cfg)
                 if not s[0].startswith("visual.")]
                + _qwen2_5_vl_vision_specs(config))
    if kind == "qwen3_vl":
        return qwen3_vl_tensor_specs(config)
    if kind == "qwen3_vl_moe":
        return qwen3_vl_moe_tensor_specs(config)
    if kind in MOE_TEXT_TYPES:
        return moe_text_tensor_specs(config)
    raise NotImplementedError(f"no tensor specs for model type {kind}")


def is_vision_key(key: str) -> bool:
    """Whether an HF checkpoint key belongs to the vision tower (LLaVA's
    projector included)."""
    return key.startswith(("visual.", "model.visual.", "vision_tower.",
                           "multi_modal_projector."))


# the routers' keys (and Qwen-MoE's shared-expert gate, a router of one
# output), whose quantization `router_bits` sets
_ROUTER_KEYS = (".mlp.gate.weight", ".block_sparse_moe.gate.weight",
                ".block_sparse_moe.router.layer.weight",
                ".mlp.shared_expert_gate.weight", ".mlp.router.weight")


def _is_quantized_in_mlx(key: str) -> bool:
    """Keys an mlx-community conversion of these families stores quantized:
    the language model's linears (the MoE families' expert stacks and
    routers too), lm_head and embed_tokens."""
    if key.startswith("model.language_model."):
        key = "model." + key[len("model.language_model."):]
    elif key.startswith("language_model."):  # LLaVA's layout
        key = key[len("language_model."):]
    return key in ("model.embed_tokens.weight", "lm_head.weight") or (
        key.startswith("model.layers.")
        and key.endswith(("_proj.weight",) + _ROUTER_KEYS))


def _mlx_path(key: str) -> str:
    """The name an mlx conversion gives the module of an HF weight key (the
    key of its per-path quantization entry): Qwen3-VL-MoE's language model
    moves under `language_model.model.`; the text families keep theirs."""
    key = key[: -len(".weight")]
    if key.startswith("model.language_model."):
        return "language_model.model." + key[len("model.language_model."):]
    return key


def mlx_quantized_checkpoint(config: dict, bits: int = 4, group_size: int = 64,
                             seed: int = 0, std: float = 0.02,
                             vision_only: bool = False,
                             router_bits: Optional[int] = None):
    """(config, weights) of a random `bits`-bit mlx-format checkpoint of
    config["model_type"] (Qwen2-VL, Qwen2.5-VL, Qwen3-VL, Qwen3-VL-MoE,
    llama, LLaVA, PaliGemma, gemma / gemma2, one of MOE_TEXT_TYPES, gpt_oss
    in the mlx layout with its expert stacks, or one of CLASSIC_TYPES,
    whose every linear, embedding table and head is quantized; bits
    4 or 8); with
    `vision_only`, the vision tower's tensors alone (drawn from the seed's
    generator in the same way).  With `router_bits`, the MoE families'
    routers (and Qwen-MoE's shared-expert gate) are drawn at those bits and
    the config's quantization gets a per-path entry for each under the
    conversion's own name ("language_model.model.layers.{i}.mlp.gate" for
    Qwen3-VL-MoE; "model.layers.{i}.mlp.gate",
    "model.layers.{i}.block_sparse_moe.gate" or
    "model.layers.{i}.block_sparse_moe.router.layer" for the text
    families: {"bits", "group_size"}), as mlx-community's MoE conversions
    keep the router at 8 bits.

    Quantized tensors: `<key>.weight` uint32 [..., out, in * bits / 32]
    (codes packed low bits first), `<key>.scales` and `<key>.biases` bf16
    [..., out, in/group] (an expert stack has a leading expert axis).
    Codes are uniform in [0, 2**bits) and each group's bias is
    -((2**bits - 1) / 2) * scale, with scales drawn so the dequantized
    weights have standard deviation ~std.  The vision tower, the q/k/v biases
    and the norms are dense bf16 (weights and biases ~ N(0, std), norms
    1 / 0).  Returns the config with its `quantization` entry added and a
    flat dict of numpy uint32 arrays and CPU torch.bfloat16 tensors."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    rng = np.random.default_rng(seed)
    qcfg = {"group_size": group_size, "bits": bits}
    w = {}
    for key, shape, fill in tensor_specs(config, "mlx"):
        if vision_only and not is_vision_key(key):
            continue
        if fill == "qrand" or _is_quantized_in_mlx(key):
            b = bits
            if router_bits and key.endswith(_ROUTER_KEYS):
                b = router_bits
                qcfg[_mlx_path(key)] = {"group_size": group_size, "bits": b}
            levels = 2**b
            s_mean = std / float(np.sqrt((levels**2 - 1) / 12.0))  # uniform
            *lead, n, k = shape
            if k % group_size or (k * b) % 32:
                raise ValueError(f"{key}: in-features {k} not a multiple of "
                                 f"the group {group_size} or of a word")
            s = rng.uniform(0.75 * s_mean, 1.25 * s_mean,
                            size=(*lead, n, k // group_size)).astype(
                                np.float32)
            base = key[: -len(".weight")]
            w[key] = rng.integers(0, 2**32, size=(*lead, n, k * b // 32),
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
    cfg = {**config, "quantization": qcfg}
    return cfg, w


def mlx_int4_checkpoint(config: dict, seed: int = 0, group_size: int = 64,
                        std: float = 0.02):
    """The 4-bit case of `mlx_quantized_checkpoint` (the same draws)."""
    return mlx_quantized_checkpoint(config, bits=4, group_size=group_size,
                                    seed=seed, std=std)


def synthetic_video(n_frames: int, size: int = 448, seed: int = 0,
                    step: int = 8) -> np.ndarray:
    """A seeded clip, uint8 [n_frames, size, size, 3]: a random first frame,
    each later frame the one before moved `step` pixels to the right
    (wrapping round) with a fresh random square of size / 8 pixels at a
    random place, so that consecutive frames share most of their pixels,
    as a video's do."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    side = max(1, size // 8)
    frames = [frame]
    for _ in range(n_frames - 1):
        frame = np.roll(frame, step, axis=1)
        y, x = rng.integers(0, size - side + 1, 2)
        frame[y:y + side, x:x + side] = rng.integers(
            0, 256, (side, side, 3), dtype=np.uint8)
        frames.append(frame)
    return np.stack(frames)


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
    """Special tokens at their ids (Qwen2-VL's public ones by default, with
    its <|im_end|> as EOS); every other UTF-8 byte is its own id (0-255).
    Enough of the HF tokenizer surface for the processors, the
    chat-template fallback and the detokenizer."""

    def __init__(self, special_tokens: Optional[dict] = None,
                 eos_token: str = "<|im_end|>",
                 pad_token: str = "<|endoftext|>"):
        self._special = dict(special_tokens or QWEN2_VL_SPECIAL_TOKENS)
        self.eos_token_id = self._special[eos_token]
        self.pad_token_id = self._special[pad_token]
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


# --------------------------------------------------- target-coupled drafters
def _drafter_widths(target: dict) -> dict:
    return {k: target[k] for k in (
        "hidden_size", "intermediate_size", "num_attention_heads",
        "num_key_value_heads", "vocab_size")}


def eagle3_drafter_config(target: dict, capture_layers: tuple) -> dict:
    """An EAGLE-3 drafter's config.json at a llama target's widths."""
    return {"model_type": "eagle3", **_drafter_widths(target),
            "capture_layers": list(capture_layers)}


def mtp_drafter_config(target: dict) -> dict:
    """An MTP drafter's config.json (qwen3_5_mtp) at a target's widths."""
    return {"model_type": "qwen3_5_mtp", **_drafter_widths(target)}


def dflash_drafter_config(target: dict, num_hidden_layers: int,
                          block_size: int, target_layer_ids: tuple,
                          mask_token_id: int = 0) -> dict:
    """A DFlash drafter's config.json (qwen3_dflash) at a target's widths:
    its head dim the target's, its block and target layers in
    `dflash_config`, as the published drafters write them."""
    hd = target.get("head_dim") or (target["hidden_size"]
                                    // target["num_attention_heads"])
    return {"model_type": "qwen3_dflash", **_drafter_widths(target),
            "num_hidden_layers": num_hidden_layers, "head_dim": hd,
            "block_size": block_size,
            "dflash_config": {"mask_token_id": mask_token_id,
                              "target_layer_ids": list(target_layer_ids)}}


def tiny_drafter_configs(target: dict) -> dict:
    """{kind: config.json} of the JAX package's test drafters over its
    tiny 3-layer llama target: EAGLE-3 capturing layers 0, 1 and 2, MTP,
    and a 2-layer DFlash of block 4 over target layers 0 and 2 with mask
    token 5."""
    return {"eagle3": eagle3_drafter_config(target, (0, 1, 2)),
            "mtp": mtp_drafter_config(target),
            "dflash": dflash_drafter_config(target, 2, 4, (0, 2), 5)}


def llama_3_1_8b_drafter_configs() -> dict:
    """{kind: config.json} of full-width drafters over Llama-3.1-8B (hidden
    4096, intermediate 14336, 32 / 8 heads, vocab 128256, 32 target
    layers): EAGLE-3 (one layer) capturing layers 2, 16 and 29 (early,
    middle and late, as EAGLE-3 takes them), MTP (one block), and DFlash
    with the reference's defaults (5 layers, block 16, target layers 1, 8,
    15, 22 and 29; drafters/__init__.py:124-132)."""
    target = llama_3_1_8b_config()
    return {"eagle3": eagle3_drafter_config(target, (2, 16, 29)),
            "mtp": mtp_drafter_config(target),
            "dflash": dflash_drafter_config(target, 5, 16,
                                            (1, 8, 15, 22, 29))}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def write_drafter_checkpoint(path, config: dict, params: dict,
                             omit=("embed_tokens", "lm_head")) -> None:
    """A drafter's directory: config.json and model.safetensors of its
    params (torch tensors or numpy arrays; bfloat16 written as BF16), a
    DFlash stack's layers as layers.<i>.*, without the `omit` subtrees
    (the target's, which load_drafter binds)."""
    import json
    from pathlib import Path

    from .loader import write_safetensors

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    params = {k: v for k, v in params.items() if k not in omit}
    flat = {}
    for k, v in _flat(params).items():
        if k.startswith("layers."):
            for i in range(v.shape[0]):
                flat[k.replace("layers.", f"layers.{i}.", 1)] = v[i]
        else:
            flat[k] = v
    arrays, bf16 = {}, []
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                bf16.append(k)
                v = v.view(torch.uint16)
            v = v.numpy()
        arrays[k] = v
    write_safetensors(path / "model.safetensors", arrays, bf16=tuple(bf16))
    (path / "config.json").write_text(json.dumps(config))


# ------------------------------------- gpt-oss and the classic decoders
# special tokens at their public ids (ByteTokenizer's arguments: tokens,
# EOS, pad): gpt-oss's harmony tokens (o200k_harmony) and phi-2's
# (GPT-2's <|endoftext|>), which the other classic families' tokenizers
# also end a text with where their vocabularies hold it
CLASSIC_SPECIAL_TOKENS = {
    "gpt_oss": ({"<|startoftext|>": 199998, "<|endoftext|>": 199999,
                 "<|return|>": 200002, "<|constrain|>": 200003,
                 "<|channel|>": 200005, "<|start|>": 200006,
                 "<|end|>": 200007, "<|message|>": 200008,
                 "<|call|>": 200012}, "<|return|>", "<|endoftext|>"),
    "phi": ({"<|endoftext|>": 50256}, "<|endoftext|>", "<|endoftext|>"),
}
CLASSIC_TYPES = ("gpt2", "gpt_neox", "gpt_bigcode", "phi", "phixtral",
                 "qwen", "stablelm", "starcoder2", "nemotron")


def tiny_gpt_oss_config(**overrides) -> dict:
    """The JAX package's gpt-oss test model (tests/test_gpt_oss.py:13),
    copied: 2 layers (sliding, full; window 4), 4 / 2 heads of 8, 4
    experts of width 24, top-2, vocab 96."""
    cfg = {
        "model_type": "gpt_oss", "hidden_size": 32, "num_hidden_layers": 2,
        "intermediate_size": 24, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 8, "num_local_experts": 4,
        "num_experts_per_tok": 2, "sliding_window": 4, "rms_norm_eps": 1e-5,
        "vocab_size": 96, "rope_theta": 150000.0,
        "layer_types": ["sliding_attention", "full_attention"],
        "tie_word_embeddings": False,
    }
    cfg.update(overrides)
    return cfg


def gpt_oss_20b_config() -> dict:
    """openai/gpt-oss-20b's published widths (config.json): 24 layers of
    hidden 2880 alternating sliding (window 128) and full attention, 64 / 8
    heads of 64 with q / k / v / o biases and sinks, 32 experts of width
    2880, 4 a token; vocab 201088, rope theta 150000 with YaRN (factor 32
    over 4096 positions, beta 32 / 1, `truncate: false`), an untied head."""
    return tiny_gpt_oss_config(
        hidden_size=2880, num_hidden_layers=24, intermediate_size=2880,
        num_attention_heads=64, num_key_value_heads=8, head_dim=64,
        num_local_experts=32, num_experts_per_tok=4, sliding_window=128,
        rms_norm_eps=1e-5, vocab_size=201088, rope_theta=150000.0,
        rope_scaling={"rope_type": "yarn", "factor": 32.0,
                      "beta_fast": 32.0, "beta_slow": 1.0,
                      "truncate": False,
                      "original_max_position_embeddings": 4096},
        layer_types=["sliding_attention", "full_attention"] * 12,
        max_position_embeddings=131072, tie_word_embeddings=False,
        attention_bias=True, swiglu_limit=7.0, eos_token_id=200002,
        pad_token_id=199999)


def gpt_oss_tensor_specs(config: dict, layout: str = "hf") -> list:
    """(key, shape, fill) of a gpt-oss checkpoint: HF's fused interleaved
    `mlp.experts.gate_up_proj` [E, D, 2I] and `down_proj` [E, I, D] with
    their biases (`layout` "hf"), or the mlx layout's split stacks
    `mlp.experts.{gate,up}_proj` [E, I, D] and `down_proj` [E, D, I]
    ("mlx").  Fill "qrand" marks the weights an mlx conversion quantizes
    (drawn as "rand" in float checkpoints); norms "ones"."""
    D, V, I = (config["hidden_size"], config["vocab_size"],
               config["intermediate_size"])
    nh, nkv, hd = (config["num_attention_heads"],
                   config["num_key_value_heads"], config["head_dim"])
    E = config["num_local_experts"]
    specs = [("model.embed_tokens.weight", (V, D), "qrand"),
             ("model.norm.weight", (D,), "ones")]
    for i in range(config["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs += [(p + "input_layernorm.weight", (D,), "ones"),
                  (p + "post_attention_layernorm.weight", (D,), "ones")]
        for nm, o, k in (("q_proj", nh * hd, D), ("k_proj", nkv * hd, D),
                         ("v_proj", nkv * hd, D), ("o_proj", D, nh * hd)):
            specs += [(p + f"self_attn.{nm}.weight", (o, k), "qrand"),
                      (p + f"self_attn.{nm}.bias", (o,), "rand")]
        specs += [(p + "self_attn.sinks", (nh,), "rand"),
                  (p + "mlp.router.weight", (E, D), "qrand"),
                  (p + "mlp.router.bias", (E,), "rand")]
        x = p + "mlp.experts."
        if layout == "hf":
            specs += [(x + "gate_up_proj", (E, D, 2 * I), "rand"),
                      (x + "gate_up_proj_bias", (E, 2 * I), "rand"),
                      (x + "down_proj", (E, I, D), "rand"),
                      (x + "down_proj_bias", (E, D), "rand")]
        else:
            for nm, o, k in (("gate_proj", I, D), ("up_proj", I, D),
                             ("down_proj", D, I)):
                specs += [(x + f"{nm}.weight", (E, o, k), "qrand"),
                          (x + f"{nm}.bias", (E, o), "rand")]
    if not config.get("tie_word_embeddings"):
        specs.append(("lm_head.weight", (V, D), "qrand"))
    return specs


def tiny_classic_config(model_type: str, **overrides) -> dict:
    """A tiny HF config.json of one of CLASSIC_TYPES: 2 layers of hidden
    64, 4 heads of 16 (starcoder2 2 KV heads, gpt_bigcode 1), vocab 128,
    each family's own flags (gpt_neox's and stablelm's rotary 0.25 with
    stablelm's per-head q / k norms and q / k / v biases, phi's rotary 0.5
    (phi-2's 0.4 of a 16-wide head would rotate 6 lanes), phixtral's 4
    experts, top-2, nemotron's linear rope scaling)."""
    D, L, H, V, P = 64, 2, 4, 128, 256
    cfg = {
        "gpt2": {"n_embd": D, "n_layer": L, "n_head": H, "vocab_size": V,
                 "n_positions": P},
        "gpt_neox": {"hidden_size": D, "num_hidden_layers": L,
                     "num_attention_heads": H, "intermediate_size": 128,
                     "vocab_size": V, "rotary_pct": 0.25,
                     "use_parallel_residual": True,
                     "tie_word_embeddings": False},
        "gpt_bigcode": {"n_embd": D, "n_layer": L, "n_head": H,
                        "n_inner": 128, "vocab_size": V, "n_positions": P,
                        "multi_query": True},
        "phi": {"hidden_size": D, "num_hidden_layers": L,
                "num_attention_heads": H, "intermediate_size": 128,
                "vocab_size": V, "partial_rotary_factor": 0.5,
                "max_position_embeddings": P},
        "phixtral": {"model_dim": D, "num_layers": L, "num_heads": H,
                     "num_vocab": V, "rotary_dim": 8,
                     "num_local_experts": 4, "num_experts_per_tok": 2},
        "qwen": {"hidden_size": D, "num_hidden_layers": L,
                 "num_attention_heads": H, "intermediate_size": 256,
                 "vocab_size": V, "kv_channels": 16},
        "stablelm": {"hidden_size": D, "num_hidden_layers": L,
                     "num_attention_heads": H, "num_key_value_heads": H,
                     "intermediate_size": 128, "vocab_size": V,
                     "partial_rotary_factor": 0.25,
                     "use_parallel_residual": False, "qk_layernorm": True,
                     "use_qkv_bias": True},
        "starcoder2": {"hidden_size": D, "num_hidden_layers": L,
                       "num_attention_heads": H, "num_key_value_heads": 2,
                       "intermediate_size": 128, "vocab_size": V,
                       "tie_word_embeddings": True},
        "nemotron": {"hidden_size": D, "num_hidden_layers": L,
                     "num_attention_heads": H, "num_key_value_heads": 2,
                     "intermediate_size": 128, "vocab_size": V,
                     "partial_rotary_factor": 0.5,
                     "rope_scaling": {"type": "linear", "factor": 2.0}},
    }[model_type]
    cfg = {"model_type": model_type, **cfg}
    cfg.update(overrides)
    return cfg


def phi_2_config() -> dict:
    """microsoft/phi-2's published widths (config.json): 32 layers of
    hidden 2560, 32 heads of 80 with a partial rotary of 0.4 (32 lanes),
    q / k / v / dense biases, an MLP of 10240, vocab 51200, 2048
    positions, an untied biased head."""
    return {"model_type": "phi", "hidden_size": 2560,
            "num_hidden_layers": 32, "num_attention_heads": 32,
            "num_key_value_heads": 32, "intermediate_size": 10240,
            "vocab_size": 51200, "max_position_embeddings": 2048,
            "partial_rotary_factor": 0.4, "rope_theta": 10000.0,
            "layer_norm_eps": 1e-5, "tie_word_embeddings": False,
            "hidden_act": "gelu_new", "qk_layernorm": False,
            "bos_token_id": 50256, "eos_token_id": 50256}


def classic_tensor_specs(config: dict, layout: str = "hf") -> list:
    """(key, shape, fill) of a checkpoint of one of CLASSIC_TYPES in its HF
    layout ("hf": gpt2's Conv1D [in, out] weights), or as an mlx
    conversion writes it ("mlx": the same names but for gpt2, whose keys
    take mlx-lm's "model." prefix and Linear layout).  Fill "qrand" marks
    the weights an mlx conversion quantizes (every linear, the embedding
    tables and the head); norm weights "ones", nemotron's (stored as
    w - 1) and every bias "rand"."""
    kind = config["model_type"]
    g = config.get

    def linear(key, o, k, bias=True, conv=False):
        shape = (k, o) if conv and layout == "hf" else (o, k)
        return [(key + ".weight", shape, "qrand")] + (
            [(key + ".bias", (o,), "rand")] if bias else [])

    def norm(key, bias=True, fill="ones"):
        return [(key + ".weight", (D,), fill)] + (
            [(key + ".bias", (D,), "rand")] if bias else [])

    specs = []
    if kind in ("gpt2", "gpt_bigcode"):
        D, L, H, V, P = (g("n_embd"), g("n_layer"), g("n_head"),
                         g("vocab_size"), g("n_positions"))
        I = g("n_inner") or 4 * D
        kvd = (D // H) * (1 if kind == "gpt_bigcode" and g("multi_query",
                                                           True) else H)
        conv = kind == "gpt2"
        pre = "model." if conv and layout == "mlx" else ""
        specs += [(pre + "wte.weight", (V, D), "qrand"),
                  (pre + "wpe.weight", (P, D), "qrand")] + norm(pre + "ln_f")
        for i in range(L):
            p = f"{pre}h.{i}."
            specs += (norm(p + "ln_1") + norm(p + "ln_2")
                      + linear(p + "attn.c_attn", D + 2 * kvd, D, conv=conv)
                      + linear(p + "attn.c_proj", D, D, conv=conv)
                      + linear(p + "mlp.c_fc", I, D, conv=conv)
                      + linear(p + "mlp.c_proj", D, I, conv=conv))
        return specs
    if kind == "gpt_neox":
        D, L, V, I = (g("hidden_size"), g("num_hidden_layers"),
                      g("vocab_size"), g("intermediate_size"))
        specs += [("gpt_neox.embed_in.weight", (V, D), "qrand")]
        specs += norm("gpt_neox.final_layer_norm")
        for i in range(L):
            p = f"gpt_neox.layers.{i}."
            specs += (norm(p + "input_layernorm")
                      + norm(p + "post_attention_layernorm")
                      + linear(p + "attention.query_key_value", 3 * D, D)
                      + linear(p + "attention.dense", D, D)
                      + linear(p + "mlp.dense_h_to_4h", I, D)
                      + linear(p + "mlp.dense_4h_to_h", D, I))
        if not g("tie_word_embeddings"):
            specs += [("embed_out.weight", (V, D), "qrand")]
        return specs
    if kind == "phixtral":
        D, L, V, E = (g("model_dim"), g("num_layers"), g("num_vocab"),
                      g("num_local_experts"))
        specs += [("transformer.embd.wte.weight", (V, D), "qrand")]
        for i in range(L):
            p = f"transformer.h.{i}."
            specs += (norm(p + "ln") + linear(p + "mixer.Wqkv", 3 * D, D)
                      + linear(p + "mixer.out_proj", D, D)
                      + [(p + "moe.gate.weight", (E, D), "qrand")])
            for e in range(E):
                specs += (linear(p + f"moe.mlp.{e}.fc1", 4 * D, D)
                          + linear(p + f"moe.mlp.{e}.fc2", D, 4 * D))
        return specs + norm("lm_head.ln") + linear("lm_head.linear", V, D)
    if kind == "qwen":
        D, L, V = g("hidden_size"), g("num_hidden_layers"), g("vocab_size")
        I = g("intermediate_size") // 2
        specs += [("transformer.wte.weight", (V, D), "qrand")]
        specs += norm("transformer.ln_f", bias=False)
        for i in range(L):
            p = f"transformer.h.{i}."
            specs += (norm(p + "ln_1", bias=False)
                      + norm(p + "ln_2", bias=False)
                      + linear(p + "attn.c_attn", 3 * D, D)
                      + linear(p + "attn.c_proj", D, D, bias=False)
                      + linear(p + "mlp.w1", I, D, bias=False)
                      + linear(p + "mlp.w2", I, D, bias=False)
                      + linear(p + "mlp.c_proj", D, I, bias=False))
        return specs + linear("lm_head", V, D, bias=False)
    # the llama-named families: phi, stablelm, starcoder2, nemotron
    D, L, V = g("hidden_size"), g("num_hidden_layers"), g("vocab_size")
    H = g("num_attention_heads")
    nkv = g("num_key_value_heads") or H
    hd = g("head_dim") or D // H
    I = g("intermediate_size") or 4 * D
    final = {"phi": "model.final_layernorm"}.get(kind, "model.norm")
    nfill = "rand" if kind == "nemotron" else "ones"
    qkv_bias = {"phi": True, "starcoder2": True, "nemotron": False,
                "stablelm": bool(g("use_qkv_bias"))}[kind]
    specs += [("model.embed_tokens.weight", (V, D), "qrand")]
    specs += norm(final, fill=nfill)
    for i in range(L):
        p = f"model.layers.{i}."
        specs += norm(p + "input_layernorm", fill=nfill)
        if kind != "phi" and not g("use_parallel_residual"):
            specs += norm(p + "post_attention_layernorm", fill=nfill)
        for nm, o in (("q_proj", H * hd), ("k_proj", nkv * hd),
                      ("v_proj", nkv * hd)):
            specs += linear(p + f"self_attn.{nm}", o, D, bias=qkv_bias)
        o_name = "dense" if kind == "phi" else "o_proj"
        specs += linear(p + f"self_attn.{o_name}", D, H * hd,
                        bias=kind in ("phi", "starcoder2"))
        if kind == "stablelm" and g("qk_layernorm"):
            specs += [(p + f"self_attn.{w}_layernorm.norms.{h}.weight",
                       (hd,), "ones")
                      for w, n in (("q", H), ("k", nkv)) for h in range(n)]
        if kind == "phi":
            specs += linear(p + "mlp.fc1", I, D) + linear(p + "mlp.fc2", D, I)
        elif kind == "starcoder2":
            specs += (linear(p + "mlp.c_fc", I, D)
                      + linear(p + "mlp.c_proj", D, I))
        elif kind == "nemotron":
            specs += (linear(p + "mlp.up_proj", I, D, bias=False)
                      + linear(p + "mlp.down_proj", D, I, bias=False))
        else:
            specs += (linear(p + "mlp.gate_proj", I, D, bias=False)
                      + linear(p + "mlp.up_proj", I, D, bias=False)
                      + linear(p + "mlp.down_proj", D, I, bias=False))
    tied = g("tie_word_embeddings", kind != "phi" and kind != "stablelm"
             and kind != "nemotron")
    if not tied:
        specs += linear("lm_head", V, D, bias=kind == "phi")
    return specs


def classic_hf_weights(config: dict, seed: int = 0, scale: float = 0.08,
                       layout: str = "hf") -> dict:
    """Random f32 weights of a gpt-oss or CLASSIC_TYPES checkpoint
    (`gpt_oss_tensor_specs` / `classic_tensor_specs` in `layout`)."""
    return _draw(tensor_specs(config, layout), np.random.default_rng(seed),
                 scale)
