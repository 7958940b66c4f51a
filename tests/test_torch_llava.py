"""Port parity: LLaVA (models/clip_vision, models/llava) and its
processor against the JAX package and HF transformers, in float32 on the
CPU on the same weights, at the JAX package's test size (a 2-layer CLIP
tower of width 32 on 28 x 28 images, the tiny llama decoder):

- host layouts exactly: the published LLaVA-1.5-7B config, the weight
  builder, `sanitize`;
- the CLIP tower's hidden state at every layer, its pooled and
  post-normed outputs, and LLaVA's merged embeddings
  and teacher-forced logits within 1e-4;
- a random 4-bit mlx checkpoint through both loaders, w8chan and exact;
- the CLIP image processor's pixel_values against transformers'
  CLIPImageProcessor built from arguments (no download), bit for bit;
- the image-token count (576 at 336 / 14), with the reference's
  processor fallback (Qwen2-VL's patch rows, which the CLIP tower cannot
  take) named as the divergence;
- `embed_prompt` on an image without a grid, through the vision cache,
  and greedy `generate` on a checkpoint on disk as the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.models.llava import Model as JaxModel
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import llava_hf_weights as jax_hf_weights
from mlx_vlm_tpu.utils.testing import tiny_llava_config as jax_tiny_config
from mlx_vlm_tpu_torch.core.quant import (ChannelQuantizedTensor,
                                          QuantizedTensor)
from mlx_vlm_tpu_torch.generate.common import embed_prompt
from mlx_vlm_tpu_torch.models.llava import Model, ModelConfig
from mlx_vlm_tpu_torch.utils.loader import (load_model_from_weights,
                                            params_from_jax)
from mlx_vlm_tpu_torch.utils.processing import (ClipImageProcessor,
                                                LlavaProcessor,
                                                prepare_inputs,
                                                processor_for)
from mlx_vlm_tpu_torch.utils.testing import (LLAVA_SPECIAL_TOKENS,
                                             ByteTokenizer,
                                             llava_1_5_7b_config,
                                             llava_hf_weights,
                                             mlx_int4_checkpoint,
                                             tiny_llama_config,
                                             tiny_llava_config)
from mlx_vlm_tpu_torch.vision_cache import VisionFeatureCache
from test_torch_qwen2_5_vl import (bench_rule, jax_leaf, tree_equal,
                                   write_checkpoint)

torch.set_num_threads(2)

IMG_TOK = 32  # tiny_llava_config's image_token_index


@pytest.fixture(scope="module")
def models():
    cfg = tiny_llava_config()
    w = llava_hf_weights(cfg, 5)
    return (jax_load(dict(cfg), dict(w), jnp.float32),
            load_model_from_weights(cfg, dict(w), torch.float32, "cpu"), cfg)


def _pixels(n=1, seed=0, side=28):
    return (np.random.default_rng(seed).standard_normal((n, 3, side, side))
            * 0.5).astype(np.float32)


def _ids(n_images=1):
    return np.array([[5, 6] + [IMG_TOK] * 4 * n_images + [7, 8, 9]])


# ------------------------------------------------------------ host layouts


def test_published_config_parses_as_the_reference():
    from mlx_vlm_tpu.models.llava import ModelConfig as JaxConfig

    d = llava_1_5_7b_config()
    got = ModelConfig.from_dict(json.loads(json.dumps(d)))
    ref = JaxConfig.from_dict(json.loads(json.dumps(d)))
    assert got.text_config.__dict__ == ref.text_config.__dict__
    assert got.vision_config.__dict__ == ref.vision_config.__dict__
    assert {k: v for k, v in got.__dict__.items() if "config" not in k} == {
        k: v for k, v in ref.__dict__.items() if "config" not in k}
    tc, vc = got.text_config, got.vision_config
    assert (tc.hidden_size, tc.num_hidden_layers, tc.num_key_value_heads,
            tc.intermediate_size, tc.vocab_size, vc.num_hidden_layers,
            vc.hidden_size, vc.image_size, got.image_token_index) == (
        4096, 32, 32, 11008, 32064, 24, 1024, 336, 32000)


def test_weight_builder_and_sanitize_equal_reference():
    cfg = tiny_llava_config()
    assert cfg == jax_tiny_config()
    ref, got = jax_hf_weights(cfg, 3), llava_hf_weights(cfg, 3)
    assert list(got) == list(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    got["vision_tower.vision_model.embeddings.position_ids"] = np.arange(5)
    a, b = Model.sanitize(dict(got)), JaxModel.sanitize(dict(got))
    assert list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    assert a["vision_tower.vision_model.embeddings.patch_embedding.weight"
             ].shape == (32, 3 * 14 * 14)


# ------------------------------------------------------------ float paths


@pytest.mark.parametrize("act", [None, "gelu"])
def test_tower_every_hidden_state(models, act):
    """CLIP's default quick-GELU and a config's exact GELU; a tower type
    that is neither CLIP nor SigLIP is refused, as in the reference."""
    from mlx_vlm_tpu.models.clip_vision import ClipVisionTower as JaxTower

    from mlx_vlm_tpu_torch.models.clip_vision import ClipVisionTower

    jm, tm, cfg = models
    vc = type(tm.config.vision_config)(
        **dict(tm.config.vision_config.__dict__, hidden_act=act))
    jt, tt = JaxTower(vc), ClipVisionTower(vc)
    pix = _pixels(2)
    ref = jt(jm.params["vision_tower"], jnp.asarray(pix))
    got = tt(tm.params["vision_tower"], torch.from_numpy(pix))
    assert got.hidden_states.shape == (3, 2, 5, 32)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="Unsupported vision model type"):
        ClipVisionTower(type(vc)(**dict(vc.__dict__,
                                        model_type="vit_vision_model")))


def test_embeddings_and_teacher_forced_logits(models):
    jm, tm, _ = models
    ids, pix = _ids(2), _pixels(2, seed=1)
    je = jm.get_input_embeddings(jm.params, jnp.asarray(ids),
                                 jnp.asarray(pix))
    te = tm.get_input_embeddings(tm.params, torch.from_numpy(ids),
                                 torch.from_numpy(pix))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-5)
    feats = tm.vision_features(tm.params, torch.from_numpy(pix))
    assert feats.shape == (8, 64)
    assert torch.equal(tm.get_input_embeddings(
        tm.params, torch.from_numpy(ids), image_features=feats), te)
    pos, deltas = jm.prepare_position_ids(ids)
    tpos, tdeltas = tm.prepare_position_ids(ids)
    assert np.array_equal(pos, tpos) and np.array_equal(deltas, tdeltas)
    jc = jm.language_model.init_cache(1, 32, jnp.float32)
    tc = tm.language_model.init_cache(1, 32, torch.float32)
    jl, jc = jm(jm.params, je, jc, jnp.asarray(pos))
    tl = tm(tm.params, te, tc, torch.from_numpy(pos.astype(np.int64)))
    ref, got = [np.asarray(jl)[0, -1]], [tl[0, -1].numpy()]
    for _ in range(4):
        tok = [[int(np.argmax(ref[-1]))]]
        p = int(jc.offset)
        jl, jc = jm(jm.params, jm.language_model.embed(
            jm.params["language_model"], jnp.asarray(tok)), jc,
            jnp.full((3, 1, 1), p, jnp.int32))
        tl = tm(tm.params, tm.language_model.embed(
            tm.params["language_model"], torch.tensor(tok)), tc,
            torch.full((3, 1, 1), p))
        ref.append(np.asarray(jl)[0, 0])
        got.append(tl[0, 0].numpy())
    ref, got = np.stack(ref), np.stack(got)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])


def test_embed_prompt_without_a_grid_and_the_vision_cache(models):
    """embed_prompt takes LLaVA's [B, 3, H, W] pixels with no grid; a
    vision-cache miss stores the projected features under a key of the
    pixels alone, and a hit embeds as the tower does."""
    _, tm, _ = models
    ids = _ids()
    inputs = {"input_ids": ids, "pixel_values": _pixels(seed=2),
              "attention_mask": np.ones_like(ids)}
    e0, pos, deltas = embed_prompt(tm, inputs)
    vc = VisionFeatureCache()
    e1, _, _ = embed_prompt(tm, inputs, vision_cache=vc)
    e2, _, _ = embed_prompt(tm, inputs, vision_cache=vc)
    assert (vc.misses, vc.hits) == (1, 1)
    assert vc.get(vc.key(inputs["pixel_values"], None)) is not None
    assert torch.equal(e0, e1) and torch.equal(e0, e2)
    assert pos.shape == (3, 1, ids.shape[1]) and int(deltas[0, 0]) == 0


# ------------------------------------------------------------ the loader


@pytest.mark.parametrize("mode", [None, "exact"])
def test_int4_checkpoint_through_both_loaders(mode, monkeypatch):
    """A 4-bit mlx LLaVA checkpoint (the decoder's linears, head and
    embeddings quantized, the tower and projector dense): w8chan by
    default, exact on request; the JAX package's parameters and
    embeddings."""
    if mode:
        monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)
    cfg, w = mlx_int4_checkpoint(tiny_llava_config(text_config=(
        tiny_llama_config(hidden_size=128, intermediate_size=256))), seed=6)
    tm = load_model_from_weights(cfg, w, torch.float32, "cpu")
    lp = tm.params["language_model"]
    kind = QuantizedTensor if mode else ChannelQuantizedTensor
    assert isinstance(lp["model"]["layers"]["mlp"]["up_proj"]["weight"], kind)
    assert isinstance(lp["lm_head"]["weight"], kind)
    assert isinstance(tm.params["multi_modal_projector"]["linear_1"][
        "weight"], torch.Tensor)
    assert not tm.language_model.fused_decode
    jm = jax_load(dict(cfg), {k: jax_leaf(v) for k, v in w.items()},
                  jnp.float32)
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    ids, pix = _ids(), _pixels(seed=3)
    je = jm.get_input_embeddings(jm.params, jnp.asarray(ids),
                                 jnp.asarray(pix))
    te = tm.get_input_embeddings(tm.params, torch.from_numpy(ids),
                                 torch.from_numpy(pix))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------ processor


@pytest.mark.parametrize("hw,size,crop", [
    ((336, 336), 336, 336), ((480, 640), 336, 336), ((300, 200), 336, 336),
    ((97, 121), 336, 336), ((180, 260), 224, 336), ((50, 90), 28, 28)])
def test_clip_processor_matches_transformers(hw, size, crop):
    from transformers import CLIPImageProcessor

    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3),
                                                  dtype=np.uint8)
    ref = CLIPImageProcessor(
        size={"shortest_edge": size}, crop_size={"height": crop,
                                                 "width": crop})(
        img, return_tensors="np")["pixel_values"]
    got = ClipImageProcessor(size, (crop, crop))(img)["pixel_values"]
    assert got.dtype == ref.dtype and got.shape == ref.shape == (1, 3, crop,
                                                                 crop)
    assert np.array_equal(got, ref)


def test_image_token_count_and_the_reference_fallback(tmp_path):
    """LLaVA-1.5's processor: each <image> becomes 576 tokens (24^2
    patches, CLS dropped) and pixel_values are [1, 3, 336, 336].  The
    reference's load_processor has no LLaVA processor and gives the
    Qwen2-VL fallback, whose 1176-value patch rows (and grid) the CLIP
    tower cannot take: the divergence kept here."""
    from mlx_vlm_tpu.utils.processing import load_processor as jax_processor

    cfg = llava_1_5_7b_config()
    model = Model(ModelConfig.from_dict(cfg))
    proc = processor_for(ByteTokenizer(LLAVA_SPECIAL_TOKENS, "</s>", "<pad>"),
                         model)
    assert isinstance(proc, LlavaProcessor) and proc.image_token == "<image>"
    img = np.random.default_rng(0).integers(0, 256, (336, 336, 3),
                                            dtype=np.uint8)
    out = prepare_inputs(proc, "USER: <image>\nWhat is this? ASSISTANT:",
                         images=img)
    assert out["pixel_values"].shape == (1, 3, 336, 336)
    assert int((out["input_ids"] == 32000).sum()) == 576
    assert "image_grid_thw" not in out
    # the reference, on a LLaVA checkpoint without processor files
    d = write_checkpoint(tmp_path, lambda base: tiny_llava_config(
        vocab_size=base["vocab_size"], image_token_index=base[
            "image_token_id"]), lambda c: llava_hf_weights(c))
    jm = JaxModel(type(model.config).from_dict(d))
    jm.config_dict = d
    ref = jax_processor(tmp_path, jm)
    assert type(ref).__name__ == "Qwen2VLProcessor"
    jout = ref.image_processor(img)
    assert jout["pixel_values"].ndim == 2
    assert jout["pixel_values"].shape[1] == 3 * 2 * 14 * 14 == 1176


# ------------------------------------------------------------ end to end


def _tiny_on_disk(base):
    return tiny_llava_config(
        vocab_size=base["vocab_size"],
        image_token_index=base["image_token_id"],
        eos_token_id=base["eos_token_id"],
        text_config=tiny_llama_config(vocab_size=base["vocab_size"]))


def test_generate_matches_on_checkpoint(tmp_path):
    """The port's load picks its LLaVA processor (the image token the
    config's index names); greedy generate on a text and an image prompt
    gives the JAX package's tokens when both take that processor."""
    write_checkpoint(tmp_path, _tiny_on_disk,
                     lambda c: llava_hf_weights(c, seed=11, scale=0.5))
    tm, tp = mlx_vlm_tpu_torch.load(str(tmp_path), dtype=torch.float32,
                                    device="cpu")
    jm = mlx_vlm_tpu.utils.loader.load_model(tmp_path, dtype=jnp.float32)
    assert isinstance(tp, LlavaProcessor)
    assert (tp.image_token, tp.num_image_tokens) == ("<|image_pad|>", 4)
    img = np.random.default_rng(1).integers(0, 256, (40, 56, 3),
                                            dtype=np.uint8)
    for text, image in (("Describe a cat.", None),
                        ("What is in this image?", img)):
        prompt = mlx_vlm_tpu_torch.apply_chat_template(
            tp, tm.config_dict, text, num_images=int(image is not None))
        jt = [r.token for r in mlx_vlm_tpu.stream_generate(
            jm, tp, prompt, image=image, max_tokens=6)]
        tt = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
            tm, tp, prompt, image=image, max_tokens=6)]
        assert tt == jt and len(tt) == 6
