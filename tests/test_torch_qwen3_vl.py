"""Port parity: the Qwen3-VL family (models/qwen3_vl) against the JAX
package, both in float32 on the CPU on the same parameters (carried by
`params_from_jax`), at the JAX package's test size (hidden 48, 4 decoder
layers, a 3-block tower with deepstack after blocks 0 and 1):

- host layouts exactly: the interleaved M-RoPE section map (and the
  chunked one), `pos_embed_interp_aux`, the tower's rotary and segment
  inputs, `prepare_position_ids`, `sanitize` on both key layouts, the
  weight builder, the model-type dispatch of the loader;
- the vision tower's features and its deepstack features within 1e-4, the
  channel-packed embeddings too;
- teacher-forced logits by bench.py's rule (and within 1e-3) over a packed
  prefill and plain decode steps; greedy `generate` tokens equal for a text
  and an image prompt on a checkpoint on disk;
- the loader: a 4-bit checkpoint loads as w8chan with the fused route off,
  the reference's default for a language model without the fused step;
- the divergences from the reference, each named: its vision cache takes
  `vision_features`' pair as plain features and fails (the port keeps the
  deepstack features); its batch admission sizes every row from the first
  row's width and fails on a text row beside an image row (the port zero-
  pads the text row's deepstack channels); its processor fallback has
  patch 14 whatever the model (the port's follows the checkpoint: 16).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.core.rope import mrope_section_map as jax_section_map
from mlx_vlm_tpu.models.qwen3_vl.qwen3_vl import Model as JaxModel
from mlx_vlm_tpu.models.qwen3_vl.vision import \
    pos_embed_interp_aux as jax_interp_aux
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu_torch.core.quant import ChannelQuantizedTensor
from mlx_vlm_tpu_torch.core.rope import mrope_section_map
from mlx_vlm_tpu_torch.models.qwen3_vl import Model, ModelConfig
from mlx_vlm_tpu_torch.models.qwen3_vl.vision import pos_embed_interp_aux
from mlx_vlm_tpu_torch.utils.loader import (get_model_and_args,
                                            load_model_from_weights)
from mlx_vlm_tpu_torch.utils.testing import (mlx_int4_checkpoint,
                                             qwen3_vl_8b_config,
                                             qwen3_vl_hf_weights,
                                             tiny_qwen3_vl_config)
from test_qwen3_vl import tiny_qwen3_vl_config as jax_tiny_config
from test_qwen3_vl import tiny_qwen3_vl_weights as jax_tiny_weights
from test_torch_qwen2_5_vl import (bench_rule, image_inputs, jax_leaf,
                                   port_of, png_data_uri, serve_chats,
                                   teacher_forced, tree_equal,
                                   write_checkpoint)

torch.set_num_threads(2)

GRIDS = ([[1, 4, 4]], [[1, 6, 8]], [[1, 4, 6], [2, 4, 4]], [[1, 10, 14]])


@pytest.fixture(scope="module")
def models():
    cfg = tiny_qwen3_vl_config()
    jm = jax_load(dict(cfg), jax_tiny_weights(jax_tiny_config(), 5),
                  jnp.float32)
    return jm, port_of(jm, Model, ModelConfig, cfg), cfg


def _tiny_on_disk(base, patch_size=14):
    cfg = tiny_qwen3_vl_config(
        image_token_id=base["image_token_id"],
        video_token_id=base["video_token_id"],
        vision_start_token_id=base["vision_start_token_id"],
        eos_token_id=base["eos_token_id"])
    cfg["text_config"] = dict(cfg["text_config"],
                              vocab_size=base["vocab_size"])
    cfg["vision_config"] = dict(cfg["vision_config"], patch_size=patch_size)
    return cfg


@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    """(JAX (model, processor), port (model, processor)) of one tiny
    checkpoint on disk (patch 14, which both processors' fallbacks
    share) with a trained tokenizer."""
    d = tmp_path_factory.mktemp("tiny_qwen3_vl")
    write_checkpoint(d, _tiny_on_disk,
                     lambda c: qwen3_vl_hf_weights(c, seed=11, scale=0.5))
    return (mlx_vlm_tpu.load(str(d), dtype=jnp.float32),
            mlx_vlm_tpu_torch.load(str(d), dtype=torch.float32,
                                   device="cpu"))


# ------------------------------------------------------------ host layouts


@pytest.mark.parametrize("sections", [[24, 20, 20], [4, 2, 2], [16, 24, 24],
                                      [8, 12, 12], [2, 3, 3]])
@pytest.mark.parametrize("style", ["interleaved", "chunked"])
def test_section_map_equals_reference(sections, style):
    got = mrope_section_map(sections, style)
    ref = jax_section_map(sections, style)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("side", [4, 48])
def test_pos_embed_interp_aux_equals_reference(grid, side):
    got = pos_embed_interp_aux(np.asarray(grid), side, 2)
    ref = jax_interp_aux(np.asarray(grid), side, 2)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_allclose(got[1].sum(axis=0), 1.0, atol=1e-6)


def test_vision_aux_and_positions_equal(models):
    jm, tm, _ = models
    for grid in GRIDS:
        ref, got = jm.vision_aux_inputs(np.asarray(grid)), \
            tm.vision_aux_inputs(np.asarray(grid))
        assert sorted(ref) == sorted(got)
        for k in ref:
            assert np.array_equal(np.asarray(ref[k]), got[k]), k
        ids, _, g = image_inputs(tm, grid)
        for gg in (g, None):
            a, b = jm.prepare_position_ids(ids, gg), tm.prepare_position_ids(
                ids, gg)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_weight_builder_and_sanitize_equal_reference():
    cfg = tiny_qwen3_vl_config()
    assert cfg == jax_tiny_config()
    ref = jax_tiny_weights(jax_tiny_config(), 3)
    got = qwen3_vl_hf_weights(cfg, seed=3)
    assert list(got) == list(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    # the HF layout, and the mlx conversions' (visual.*, model.*)
    mlx = {k.replace("model.visual.", "visual.").replace(
        "model.language_model.", "model."): v for k, v in got.items()}
    mlx["visual.patch_embed.position_ids"] = np.arange(3)
    for layout in (got, mlx):
        a, b = Model.sanitize(dict(layout)), JaxModel.sanitize(dict(layout))
        assert list(a) == list(b)
        assert all(a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
                   for k in b)
    assert Model.sanitize(dict(got)).keys() == Model.sanitize(dict(mlx)).keys()


def test_published_config_parses_as_the_reference():
    from mlx_vlm_tpu.models.qwen3_vl import ModelConfig as JaxConfig

    d = qwen3_vl_8b_config()
    got = ModelConfig.from_dict(json.loads(json.dumps(d)))
    ref = JaxConfig.from_dict(json.loads(json.dumps(d)))
    assert got.text_config.__dict__ == ref.text_config.__dict__
    assert got.vision_config.__dict__ == ref.vision_config.__dict__
    assert (got.text_config.hidden_size, got.text_config.num_hidden_layers,
            got.vision_config.patch_size) == (4096, 36, 16)


@pytest.mark.parametrize("model_type", ["idefics2", "deepseek_v2", "gemma3"])
def test_unported_model_types_raise(model_type):
    with pytest.raises(NotImplementedError, match=model_type):
        get_model_and_args({"model_type": model_type})
    for t in ("qwen2_vl", "qwen2_5_vl", "qwen3_vl", "qwen3_vl_moe"):
        assert get_model_and_args({"model_type": t})[0].__name__.endswith(t)


# ------------------------------------------------------------ float paths


@pytest.mark.parametrize("grid", GRIDS[:3])
def test_tower_deepstack_and_packed_embeddings(models, grid):
    jm, tm, cfg = models
    ids, pix, grid = image_inputs(tm, grid)
    jaux = {k: jnp.asarray(v) for k, v in jm.vision_aux_inputs(grid).items()}
    taux = {k: torch.from_numpy(v)
            for k, v in tm.vision_aux_inputs(grid).items()}
    jf, jds = jm.vision_features(jm.params, jnp.asarray(pix), **jaux)
    tf, tds = tm.vision_features(tm.params, torch.from_numpy(pix), **taux)
    assert tds.shape == jds.shape == (2, tf.shape[0], 48)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tds.numpy(), np.asarray(jds), atol=1e-4,
                               rtol=1e-4)
    ref = np.asarray(jm.get_input_embeddings(
        jm.params, jnp.asarray(ids), jnp.asarray(pix), **jaux))
    got = tm.get_input_embeddings(tm.params, torch.from_numpy(ids),
                                  torch.from_numpy(pix), **taux).numpy()
    assert got.shape == ref.shape == (1, ids.shape[1], 48 * 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert np.abs(got[0, 0, 48:]).max() == 0.0  # text rows: no deepstack


@pytest.mark.parametrize("grid", GRIDS[:2])
def test_teacher_forced_logits(models, grid):
    jm, tm, _ = models
    ids, pix, grid = image_inputs(tm, grid)
    ref, got = teacher_forced(jm, tm, ids, pix, grid)
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_deepstack_levels_past_the_last_layer(models):
    """With fewer decoder layers than deepstack levels the upstream model
    adds the levels that have a layer; the port does the same, which the
    first layers' output shows against a model without deepstack."""
    _, tm, cfg = models
    cfg2 = dict(cfg, text_config=dict(cfg["text_config"],
                                      num_hidden_layers=1))
    t1 = Model(ModelConfig.from_dict(cfg2))
    lp = dict(tm.params["language_model"])
    lp["model"] = dict(lp["model"])
    lp["model"]["layers"] = jax.tree_util.tree_map(
        lambda a: a[:1], lp["model"]["layers"])
    ids, pix, grid = image_inputs(tm, GRIDS[0])
    aux = {k: torch.from_numpy(v)
           for k, v in tm.vision_aux_inputs(grid).items()}
    e = tm.get_input_embeddings(tm.params, torch.from_numpy(ids),
                                torch.from_numpy(pix), **aux)
    pos = torch.from_numpy(tm.prepare_position_ids(ids, grid)[0].astype(
        np.int64))
    h = t1.language_model(lp, e, None, pos)
    manual = t1.language_model(lp, e[..., :48], None, pos)
    assert not torch.allclose(h, manual)  # level 0 added ...
    e2 = e.clone()
    e2[..., 96:] = 0  # ... level 1 not: zeroing it changes nothing
    assert torch.equal(t1.language_model(lp, e2, None, pos), h)


def test_generate_matches_on_checkpoint(on_disk):
    (jm, jp), (tm, tp) = on_disk
    img = np.random.default_rng(1).integers(0, 256, (84, 112, 3),
                                            dtype=np.uint8)
    for text, image in (("Describe a cat.", None),
                        ("What is in this image?", img)):
        n_img = int(image is not None)
        jprompt = mlx_vlm_tpu.apply_chat_template(jp, jm.config_dict, text,
                                                  num_images=n_img)
        tprompt = mlx_vlm_tpu_torch.apply_chat_template(
            tp, tm.config_dict, text, num_images=n_img)
        assert jprompt == tprompt
        jt = [r.token for r in mlx_vlm_tpu.stream_generate(
            jm, jp, jprompt, image=image, max_tokens=8, prefill_step_size=64)]
        tt = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
            tm, tp, tprompt, image=image, max_tokens=8, prefill_step_size=64)]
        assert tt == jt and len(tt) == 8


# ------------------------------------------------------------ the loader


def test_int4_checkpoint_loads_w8chan_with_the_route_off():
    cfg = tiny_qwen3_vl_config()
    cfg["text_config"] = dict(cfg["text_config"], hidden_size=128,
                              intermediate_size=256, head_dim=32)
    cfg["vision_config"] = dict(cfg["vision_config"], out_hidden_size=128)
    cfg, w = mlx_int4_checkpoint(cfg, seed=4)
    tm = load_model_from_weights(cfg, w, torch.bfloat16, "cpu")
    lp = tm.params["language_model"]
    for leaf in (lp["model"]["layers"]["mlp"]["up_proj"]["weight"],
                 lp["lm_head"]["weight"], lp["model"]["embed_tokens"]["weight"]):
        assert isinstance(leaf, ChannelQuantizedTensor) and leaf.src_bits == 4
    assert not tm.language_model.fused_decode
    jm = jax_load(dict(cfg), {k: jax_leaf(v) for k, v in w.items()},
                  jnp.bfloat16)
    assert "fused_decode" not in jm.params["language_model"]
    tree_equal(tm.params, port_of(jm, Model, ModelConfig, cfg).params)


# ------------------------------------------------------------ divergences


def _image_request(tm, grid=((1, 4, 4),)):
    ids, pix, grid = image_inputs(tm, list(grid))
    return {"input_ids": ids, "pixel_values": pix, "image_grid_thw": grid,
            "attention_mask": np.ones_like(ids)}


def test_vision_cache_keeps_deepstack(models):
    """The reference's embed with a vision cache passes `vision_features`'
    (features, deepstack) pair as plain features and raises (AttributeError:
    'tuple' object has no attribute 'shape') on a miss and a hit alike;
    the port's keeps the pair, so a hit embeds as the tower does."""
    from mlx_vlm_tpu.generate.dispatch import stream_generate as jstream
    from mlx_vlm_tpu.vision_cache import VisionFeatureCache as JaxCache

    from mlx_vlm_tpu_torch.generate.common import embed_prompt
    from mlx_vlm_tpu_torch.vision_cache import VisionFeatureCache

    jm, tm, _ = models
    inputs = _image_request(tm)

    class Proc:
        tokenizer = mlx_vlm_tpu_torch.utils.testing.ByteTokenizer()

        def __call__(self, text=None, images=None, **kw):
            return dict(inputs)

    img = np.zeros((28, 28, 3), np.uint8)
    with pytest.raises(AttributeError, match="tuple"):
        list(jstream(jm, Proc(), "x", image=img, max_tokens=2,
                     vision_cache=JaxCache()))
    plain, pos, deltas = embed_prompt(tm, inputs)
    cache = VisionFeatureCache()
    miss = embed_prompt(tm, inputs, cache)
    hit = embed_prompt(tm, inputs, cache)
    assert (cache.misses, cache.hits) == (1, 1)
    for e, p, d in (miss, hit):
        assert torch.equal(e, plain) and e.shape[-1] == 48 * 3
        assert np.array_equal(p, pos) and np.array_equal(d, deltas)


def test_mixed_width_admission(models):
    """A text prompt ([1, S, D]) and an image prompt ([1, S, 3D]) admitted
    together: the reference's admission raises (it sizes the batch from
    the first row's width); the port's zero-pads the text row's deepstack
    channels, and every row decodes the tokens of its prompt alone."""
    from mlx_vlm_tpu.generate.batch import BatchGenerator as JaxBatch
    from mlx_vlm_tpu.generate.batch import BatchRequest as JaxRequest

    from mlx_vlm_tpu_torch.generate import ar
    from mlx_vlm_tpu_torch.generate.batch import BatchGenerator, BatchRequest
    from mlx_vlm_tpu_torch.generate.common import embed_prompt

    jm, tm, _ = models
    text = {"input_ids": np.arange(20, 31)[None]}
    prompts = [embed_prompt(tm, x) for x in (text, _image_request(tm))]
    assert [p[0].shape[-1] for p in prompts] == [48, 144]

    jgen = JaxBatch(jm, num_slots=2, capacity=128, dtype=jnp.float32)
    for u, (e, p, d) in enumerate(prompts):
        jgen.insert(JaxRequest(uid=u, inputs_embeds=jnp.asarray(e.numpy()),
                               max_tokens=5, position_ids=p,
                               rope_delta=int(d[0, 0])))
    with pytest.raises(ValueError):
        jgen.next()

    gen = BatchGenerator(tm, num_slots=2, capacity=128, dtype=torch.float32)
    for u, (e, p, d) in enumerate(prompts):
        gen.insert(BatchRequest(uid=u, inputs_embeds=e, max_tokens=5,
                                position_ids=p, rope_delta=int(d[0, 0])))
    out = {0: [], 1: []}
    while gen.num_active or gen.queue:
        for uid, pairs in gen.next().items():
            out[uid].extend(t for t, _ in pairs)
    assert gen.stats["admissions"] == 1  # one batched admission of both
    for u, (e, p, d) in enumerate(prompts):
        alone = [int(t[0]) for t, _ in ar.generate_step(
            e, tm, position_ids=p, rope_deltas=d, max_tokens=5)]
        assert out[u] == alone


def test_processor_patch_size_follows_the_checkpoint(tmp_path):
    """A Qwen3-VL checkpoint with patch 16 and no preprocessor config: the
    reference's processor fallback cuts 14-pixel patches (rows of 1176
    values that its patch embed cannot take); the port's cuts 16-pixel
    ones, so 32 x 32 pixels a merged token.  With a preprocessor config the
    port reads its sizes."""
    from mlx_vlm_tpu.utils.processing import prepare_inputs as jprep

    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    write_checkpoint(tmp_path, lambda b: _tiny_on_disk(b, patch_size=16),
                     lambda c: qwen3_vl_hf_weights(c, seed=1))
    jm, jp = mlx_vlm_tpu.load(str(tmp_path), dtype=jnp.float32)
    tm, tp = mlx_vlm_tpu_torch.load(str(tmp_path), dtype=torch.float32,
                                    device="cpu")
    img = np.random.default_rng(3).integers(0, 256, (64, 96, 3),
                                            dtype=np.uint8)
    prompt = mlx_vlm_tpu_torch.apply_chat_template(tp, tm.config_dict, "Hi",
                                                   num_images=1)
    ref, got = jprep(jp, prompt, images=img), prepare_inputs(tp, prompt,
                                                             images=img)
    assert ref["pixel_values"].shape[1] == 3 * 2 * 14 * 14
    assert got["pixel_values"].shape[1] == 3 * 2 * 16 * 16
    assert got["image_grid_thw"].tolist() == [[1, 4, 6]]
    toks = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
        tm, tp, prompt, image=img, max_tokens=3)]
    assert len(toks) == 3
    (tmp_path / "preprocessor_config.json").write_text(json.dumps(
        {"patch_size": 16, "merge_size": 2, "temporal_patch_size": 2,
         "image_mean": [0.5] * 3, "image_std": [0.5] * 3,
         "size": {"shortest_edge": 64 * 64, "longest_edge": 128 * 128}}))
    from mlx_vlm_tpu_torch.utils.processing import image_processor_for

    ip = image_processor_for(tm, tmp_path)
    assert (ip.patch_size, ip.min_pixels, ip.max_pixels) == (16, 4096, 16384)
    assert np.array_equal(ip.image_mean, np.full(3, 0.5, np.float32))


def test_batch_generate_and_server(on_disk):
    """batch_generate of a text and an image prompt (one admission of
    both widths) gives each prompt's stream_generate text; the server
    answers a text chat as the JAX package's does and an image chat
    twice (the second from its vision cache) with the same text."""
    from mlx_vlm_tpu_torch.generate.batch import batch_generate

    (jm, jp), (tm, tp) = on_disk
    img = np.random.default_rng(2).integers(0, 256, (56, 84, 3),
                                            dtype=np.uint8)
    prompts = [mlx_vlm_tpu_torch.apply_chat_template(
        tp, tm.config_dict, t, num_images=n)
        for t, n in (("Describe a cat.", 0), ("What is in this image?", 1))]
    images = [None, img]
    got = batch_generate(tm, tp, prompts, images=images, max_tokens=6,
                         num_slots=2, capacity=256)
    alone = [mlx_vlm_tpu_torch.generate(tm, tp, p, image=i, max_tokens=6).text
             for p, i in zip(prompts, images)]
    assert got.texts == alone and got.generator_stats["admissions"] == 1
    text = {"messages": [{"role": "user", "content": "Describe a cat."}],
            "max_tokens": 6}
    image = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "What is in this image?"},
        {"type": "image_url", "image_url": {"url": png_data_uri()}}]}],
        "max_tokens": 6}
    out = serve_chats([("jax", jm, jp)], [text], "tiny-qwen3-vl")
    port = serve_chats([("port", tm, tp)], [text, image, image],
                       "tiny-qwen3-vl")["port"]
    assert (port[0]["choices"][0]["message"]["content"]
            == out["jax"][0]["choices"][0]["message"]["content"])
    assert port[1]["choices"][0]["message"]["content"] == \
        port[2]["choices"][0]["message"]["content"]
    assert port[1]["usage"]["completion_tokens"] == 6
