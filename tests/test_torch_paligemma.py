"""Port parity: PaliGemma (models/paligemma, the SigLIP branch of
models/clip_vision) against the JAX package in float32 on the CPU on the
same weights, at the JAX package's test size (a 4-layer gemma / gemma2
decoder of width 48, a 2-layer SigLIP tower of width 32 on 28 x 28 images;
the JAX side jitted).  The substrate it added, text-only gemma / gemma2
and the processor are in test_torch_gemma_text.py.

- host layouts exactly: the published PaliGemma2-3B / PaliGemma-3B configs
  and the tiny ones, the weight builder, `sanitize`;
- the SigLIP tower's every hidden state, pooled and post-normed output, the
  gemma and gemma2 decoders' prefill (the bidirectional prefix) and decode
  steps (past gemma2's window of 4) within 1e-4, and the masks each layer
  takes;
- the padded prefill: the port's logits at the prompt's last row equal an
  unpadded forward whatever the chunking (single stream and a batched
  admission), where the JAX package's padded prefill moves them
  (`test_reference_prefix_sees_its_padding`);
- no prefix caching for the bidirectional prefix (the reference's pages
  rows that depend on another prompt's text);
- a random 4-bit mlx checkpoint through both loaders (w8chan by default,
  exact on request), and `stream_generate` on a checkpoint on disk.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_vlm_tpu_torch
from mlx_vlm_tpu.generate.ar import generate_step as jax_generate_step
from mlx_vlm_tpu.models.paligemma import Model as JaxModel
from mlx_vlm_tpu.models.paligemma import ModelConfig as JaxConfig
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import paligemma_hf_weights as jax_hf_weights
from mlx_vlm_tpu.utils.testing import tiny_paligemma_config as jax_tiny_config
from mlx_vlm_tpu_torch.core.quant import (ChannelQuantizedTensor,
                                          QuantizedTensor)
from mlx_vlm_tpu_torch.generate.ar import generate_step
from mlx_vlm_tpu_torch.generate.batch import BatchGenerator
from mlx_vlm_tpu_torch.generate.common import embed_prompt
from mlx_vlm_tpu_torch.models.paligemma import Model, ModelConfig
from mlx_vlm_tpu_torch.utils.loader import (load_model,
                                            load_model_from_weights,
                                            params_from_jax,
                                            write_safetensors)
from mlx_vlm_tpu_torch.utils.processing import (PaliGemmaProcessor,
                                                prepare_inputs,
                                                processor_for)
from mlx_vlm_tpu_torch.utils.testing import (PALIGEMMA_SPECIAL_TOKENS,
                                             ByteTokenizer,
                                             mlx_int4_checkpoint,
                                             paligemma2_3b_224_config,
                                             paligemma_3b_224_config,
                                             paligemma_hf_weights,
                                             tiny_paligemma_config)
from mlx_vlm_tpu_torch.vision_cache import VisionFeatureCache
from test_torch_qwen2_5_vl import jax_leaf, tree_equal

torch.set_num_threads(2)

IMG_TOK = 64  # tiny_paligemma_config's image_token_index


@pytest.fixture(scope="module", params=["gemma", "gemma2"])
def models(request):
    """(JAX model, port model, config) of the tiny PaliGemma with a gemma
    or a gemma2 text model, on the same f32 weights."""
    cfg = tiny_paligemma_config(gemma2=request.param == "gemma2")
    w = paligemma_hf_weights(cfg, 3)
    return (jitted(jax_load(dict(cfg), dict(w), jnp.float32)),
            load_model_from_weights(cfg, dict(w), torch.float32, "cpu"), cfg)


def jitted(jm):
    """The JAX model with its forward and embedding jitted (`jit_call`,
    `jit_embed`): one compile a shape instead of one an op."""
    jm.jit_call = jax.jit(jm.__call__)
    jm.jit_embed = jax.jit(jm.get_input_embeddings)
    return jm


def _pixels(n=1, seed=0, side=28):
    return (np.random.default_rng(seed).standard_normal((n, 3, side, side))
            * 0.5).astype(np.float32)


def _ids(n_text=5, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([[IMG_TOK] * 4, [2],
                           rng.integers(70, 250, n_text)])[None]


def _embeds(jm, tm, ids, pix):
    return (jm.jit_embed(jm.params, jnp.asarray(ids), jnp.asarray(pix)),
            tm.get_input_embeddings(tm.params, torch.from_numpy(ids),
                                    torch.from_numpy(pix)))


def _jax_forward(jm, embeds, capacity, chunks=None):
    """The JAX package's forward over the prompt's own rows (no padding),
    in one call or in `chunks` (row counts) -> (logits at every row
    [S, V], cache)."""
    cache = jm.language_model.init_cache(1, capacity, jnp.float32)
    S = embeds.shape[1]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, None],
                           (3, 1, S))
    out, c0 = [], 0
    for n in chunks or [S]:
        lg, cache = jm.jit_call(jm.params, embeds[:, c0:c0 + n], cache,
                                pos[:, :, c0:c0 + n])
        out.append(np.asarray(lg)[0])
        c0 += n
    return np.concatenate(out), cache


# ------------------------------------------------------------ host layouts


@pytest.mark.parametrize("name", ["paligemma2_3b", "paligemma_3b",
                                  "tiny_gemma", "tiny_gemma2"])
def test_published_configs_parse_as_the_reference(name):
    d = {"paligemma2_3b": paligemma2_3b_224_config,
         "paligemma_3b": paligemma_3b_224_config,
         "tiny_gemma": lambda: tiny_paligemma_config(),
         "tiny_gemma2": lambda: tiny_paligemma_config(gemma2=True)}[name]()
    got = ModelConfig.from_dict(json.loads(json.dumps(d)))
    ref = JaxConfig.from_dict(json.loads(json.dumps(d)))
    assert got.text_config.__dict__ == ref.text_config.__dict__
    assert got.vision_config.__dict__ == ref.vision_config.__dict__
    assert {k: v for k, v in got.__dict__.items() if "config" not in k} == {
        k: v for k, v in ref.__dict__.items() if "config" not in k}
    tc, vc = got.text_config, got.vision_config
    assert tc.use_bidirectional_attention is True
    if name == "paligemma2_3b":
        assert (tc.hidden_size, tc.num_hidden_layers, tc.head_dim,
                tc.num_key_value_heads, tc.vocab_size,
                vc.num_hidden_layers, vc.projection_dim) == (
            2304, 26, 256, 4, 257216, 27, 2304)
        assert tc.layer_types == ["sliding_attention",
                                  "full_attention"] * 13
        assert got.hidden_size == 2048  # the stale root key, kept
    if name == "paligemma_3b":
        assert (tc.head_dim, tc.num_key_value_heads, tc.layer_types,
                vc.projection_dim) == (256, 1, None, 2048)


@pytest.mark.parametrize("gemma2", [False, True])
def test_weight_builder_and_sanitize_equal_reference(gemma2):
    cfg = tiny_paligemma_config(gemma2=gemma2)
    assert cfg == jax_tiny_config(gemma2=gemma2)
    ref, got = jax_hf_weights(cfg, 3), paligemma_hf_weights(cfg, 3)
    assert list(got) == list(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    got["language_model.model.layers.0.self_attn.rotary_emb.inv_freq"] = \
        np.ones(4)
    got["vision_tower.vision_model.embeddings.position_ids"] = np.arange(4)
    a, b = Model.sanitize(dict(got)), JaxModel.sanitize(dict(got))
    assert list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    assert a["vision_tower.vision_model.embeddings.patch_embedding.weight"
             ].shape == (32, 3 * 14 * 14)


# ------------------------------------------------------------ float paths


def test_siglip_tower_every_hidden_state(models):
    """SigLIP: no class token, no pre-norm, tanh GELU, mean pooling; an
    unknown tower type is refused as in the reference."""
    from mlx_vlm_tpu.models.clip_vision import ClipVisionTower as JaxTower

    from mlx_vlm_tpu_torch.models.clip_vision import ClipVisionTower

    jm, tm, _ = models
    vc = tm.config.vision_config
    pix = _pixels(2)
    ref = JaxTower(vc)(jm.params["vision_tower"], jnp.asarray(pix))
    got = ClipVisionTower(vc)(tm.params["vision_tower"],
                              torch.from_numpy(pix))
    assert got.hidden_states.shape == (3, 2, 4, 32)
    assert got.pooled.shape == (2, 32)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="Unsupported vision model type"):
        ClipVisionTower(type(vc)(**dict(vc.__dict__, model_type="vit")))


def test_decoder_prefill_and_decode_steps(models):
    """The merged embeddings, then the prefill (the bidirectional prefix)
    and 6 decode steps on the JAX package's greedy tokens (the cursor
    passes gemma2's window of 4), within 1e-4; the tower's features
    through `vision_features` merge as the tower's do."""
    jm, tm, _ = models
    ids, pix = _ids(), _pixels(seed=1)
    je, te = _embeds(jm, tm, ids, pix)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6)
    feats = tm.vision_features(tm.params, torch.from_numpy(pix))
    assert feats.shape == (4, 48)
    assert torch.equal(tm.get_input_embeddings(
        tm.params, torch.from_numpy(ids), image_features=feats), te)
    pos, deltas = jm.prepare_position_ids(ids)
    tpos, tdeltas = tm.prepare_position_ids(ids)
    assert np.array_equal(pos, tpos) and np.array_equal(deltas, tdeltas)
    jc = jm.language_model.init_cache(1, 32, jnp.float32)
    tc_ = tm.language_model.init_cache(1, 32, torch.float32)
    jl, jc = jm.jit_call(jm.params, je, jc, jnp.asarray(pos))
    tl = tm(tm.params, te, tc_, torch.from_numpy(pos.astype(np.int64)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    ref, got = [], []
    for _ in range(6):
        tok = [[int(np.argmax(np.asarray(jl)[0, -1]))]]
        p = int(jc.offset)
        jl, jc = jm.jit_call(jm.params, jm.language_model.embed(
            jm.params["language_model"], jnp.asarray(tok)), jc,
            jnp.full((3, 1, 1), p, jnp.int32))
        tl = tm(tm.params, tm.language_model.embed(
            tm.params["language_model"], torch.tensor(tok)), tc_,
            torch.full((3, 1, 1), p))
        ref.append(np.asarray(jl)[0, 0])
        got.append(tl[0, 0].numpy())
    assert int(tc_.offset) == int(jc.offset) == ids.shape[1] + 6
    np.testing.assert_allclose(np.stack(got), np.stack(ref), rtol=1e-4,
                               atol=1e-4)
    if tm.language_model.is_gemma2:  # the final soft-cap bounds the logits
        assert np.abs(np.stack(got)).max() <= 30.0


def test_masks_of_each_layer(models):
    """The prefix mask of a chunk (every written row, no causal order, the
    window ignored) and decode's causal and sliding masks, equal to the
    reference's `_masks`; gemma2's layers alternate, sliding first."""
    jm, tm, cfg = models
    jlm, tlm = jm.language_model, tm.language_model
    lp = np.array([1], np.int32)
    jc = jlm.init_cache(1, 16, jnp.float32, jnp.asarray(lp))
    tc_ = tlm.init_cache(1, 16, torch.float32, torch.from_numpy(lp))
    for off, S in ((0, 6), (6, 1), (9, 1), (9, 3)):
        jc = jc.__class__(k=jc.k, v=jc.v, offset=jnp.asarray(off, jnp.int32),
                          left_pad=jc.left_pad)
        tc_.offset.fill_(off)
        ref = [np.asarray(m) for m in jlm._masks(jc, 1, S)]
        got = [m.numpy() for m in tlm.masks(tc_, 1, S, "cpu")]
        for r, g in zip(ref, got):
            assert np.array_equal(np.broadcast_to(r, g.shape), g)
    assert tlm.is_full == list(np.asarray(jlm.is_full))
    if tlm.is_gemma2:
        assert tlm.is_full == [False, True, False, True]
        full, sliding = tlm.masks(tc_, 1, 1, "cpu")
        assert full.sum() == 9 and sliding.sum() == 4  # window 4 at row 9


# ------------------------------------------------------------ padding


def _recording_sampler(store):
    def sampler(logits, *rest):
        store.append(np.asarray(logits))
        return logits.argmax(-1)
    return sampler


@pytest.mark.parametrize("prefill_step", [512, 4])
def test_reference_prefix_sees_its_padding(models, prefill_step):
    """The JAX package pads the prompt to a whole prefill chunk and its
    prefix mask reaches the padding (full_valid_mask(lp, offset + S_pad)),
    so its prefill logits at the prompt's last row move with the chunk
    size; the port stops the mask at the prompt's end and equals the
    unpadded forward (in 4-row chunks: each chunk seeing the rows written
    so far, the reference's rule) within 1e-4."""
    jm, tm, _ = models
    ids, pix = _ids(), _pixels(seed=4)
    je, te = _embeds(jm, tm, ids, pix)
    S = ids.shape[1]  # 10 rows: 4 image, BOS, 5 text
    chunks = None if prefill_step > S else [4, 4, 2]
    unpadded, _ = _jax_forward(jm, je, 32, chunks)
    jax_first, port_first = [], []
    list(jax_generate_step(je, jm, max_tokens=1,
                           prefill_step_size=prefill_step,
                           sampler=_recording_sampler(jax_first)))
    list(generate_step(te, tm, max_tokens=1, prefill_step_size=prefill_step,
                       sampler=_recording_sampler(port_first)))
    ref = unpadded[-1]
    scale = np.abs(ref).max()
    np.testing.assert_allclose(port_first[0][0], ref, rtol=0,
                               atol=1e-4 * scale)
    assert np.abs(jax_first[0][0] - ref).max() > 1e-2 * scale


def test_batched_admission_stops_each_row_at_its_prompt(models):
    """Two prompts of different lengths right-padded into one batched
    prefill (BatchGenerator's admission of cold prompts, in 8-row
    chunks): each row's first logits equal its prompt's unpadded
    forward."""
    from mlx_vlm_tpu_torch.generate.batch import BatchRequest

    jm, tm, _ = models
    rows = [_ids(5, seed=1), _ids(2, seed=2)]
    pix = _pixels(seed=5)
    gen = BatchGenerator(tm, num_slots=2, capacity=64, dtype=torch.float32,
                         prefill_step_size=8)
    got, first = [], gen._first
    gen._first = lambda logits, reqs: (got.append(logits.numpy()),
                                       first(logits, reqs))[1]
    refs = []
    for i, r in enumerate(rows):
        je, te = _embeds(jm, tm, r, pix)
        n = r.shape[1]
        refs.append(_jax_forward(jm, je, 32, [8, n - 8] if n > 8
                                 else None)[0][-1])
        gen.insert(BatchRequest(uid=i, inputs_embeds=te, max_tokens=1))
    gen.next()
    assert len(got) == 1 and gen.decode.stats["admissions"] == 1
    for g, r in zip(got[0], refs):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_prefix_caching_is_off_for_the_bidirectional_prefix(disk_model):
    """A cached prefix of PaliGemma's would hold rows computed while
    attending to another prompt's later rows (the reference pages them as
    any other): the port takes no APC for it, so that a second request with
    the same image and another prompt answers as its cold run; a warm
    prompt cache given by hand is refused."""
    from mlx_vlm_tpu_torch import apc as tapc
    from mlx_vlm_tpu_torch.apc_adapters import model_apc_mode
    from mlx_vlm_tpu_torch.generate.batch import BatchRequest

    cfg, _, tm, tp = disk_model
    assert model_apc_mode(tm) is None and model_apc_mode(tm, 4) is None
    img = np.random.default_rng(2).integers(0, 256, (28, 28, 3),
                                            dtype=np.uint8)

    def run(text, apc=None):
        prompt = mlx_vlm_tpu_torch.apply_chat_template(tp, cfg, text,
                                                       num_images=1)
        res = list(mlx_vlm_tpu_torch.stream_generate(
            tm, tp, prompt, image=img, max_tokens=3, apc=apc))
        return [r.token for r in res], [np.asarray(r.logprobs) for r in res]

    apc = tapc.APCManager(num_blocks=64, block_size=4)
    run("caption en", apc)
    warm, cold = run("caption es", apc), run("caption es")
    assert warm[0] == cold[0]
    for a, b in zip(warm[1], cold[1]):
        np.testing.assert_array_equal(a, b)
    assert apc.stats.hits == 0 and apc.stats.stores == 0
    cache = tm.language_model.init_cache(1, 64, torch.float32)
    cache.offset.fill_(8)
    e = torch.zeros((1, 12, cfg["text_config"]["hidden_size"]))
    with pytest.raises(ValueError, match="bidirectional prefix"):
        list(generate_step(e, tm, max_tokens=1, prompt_cache=cache,
                           prefix_len=8))
    gen = BatchGenerator(tm, num_slots=1, capacity=64, dtype=torch.float32)
    with pytest.raises(ValueError, match="bidirectional prefix"):
        gen.insert(BatchRequest(uid=0, inputs_embeds=e, prompt_cache=cache,
                                prefix_len=8))


# ------------------------------------------------------------ the loader


@pytest.mark.parametrize("mode", [None, "exact"])
def test_int4_checkpoint_through_both_loaders(mode, monkeypatch):
    """A 4-bit mlx PaliGemma checkpoint (the decoder's linears and its
    tied embedding quantized, the tower and projector dense): w8chan by
    default, exact on request; the JAX package's parameters, embeddings
    and logits."""
    if mode:
        monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)
    cfg = tiny_paligemma_config(gemma2=True, projection_dim=128)
    cfg["text_config"].update(hidden_size=128, intermediate_size=256)
    cfg["vision_config"]["projection_dim"] = 128
    cfg, w = mlx_int4_checkpoint(cfg, seed=6)
    tm = load_model_from_weights(cfg, w, torch.float32, "cpu")
    lp = tm.params["language_model"]
    kind = QuantizedTensor if mode else ChannelQuantizedTensor
    assert isinstance(lp["model"]["layers"]["mlp"]["up_proj"]["weight"], kind)
    assert isinstance(lp["model"]["embed_tokens"]["weight"], kind)
    assert "lm_head" not in lp
    assert isinstance(tm.params["multi_modal_projector"]["linear"]["weight"],
                      torch.Tensor)
    assert not tm.language_model.fused_decode
    jm = jitted(jax_load(dict(cfg), {k: jax_leaf(v) for k, v in w.items()},
                         jnp.float32))
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    ids, pix = _ids(), _pixels(seed=3)
    je, te = _embeds(jm, tm, ids, pix)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-4)
    ref, _ = _jax_forward(jm, je, 32)
    got = tm(tm.params, te, tm.language_model.init_cache(1, 32,
                                                         torch.float32),
             torch.arange(ids.shape[1]).expand(3, 1, -1))
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


# ------------------------------------------------------------ end to end


def test_embed_prompt_through_the_vision_cache(models):
    """embed_prompt takes PaliGemma's [B, 3, H, W] pixels with no grid; a
    vision-cache miss stores the projected features, a hit embeds as the
    tower does."""
    _, tm, _ = models
    ids = _ids()
    inputs = {"input_ids": ids, "pixel_values": _pixels(seed=2),
              "attention_mask": np.ones_like(ids)}
    e0, pos, deltas = embed_prompt(tm, inputs)
    vc = VisionFeatureCache()
    e1, _, _ = embed_prompt(tm, inputs, vision_cache=vc)
    e2, _, _ = embed_prompt(tm, inputs, vision_cache=vc)
    assert (vc.misses, vc.hits) == (1, 1)
    assert torch.equal(e0, e1) and torch.equal(e0, e2)
    assert pos.shape == (3, 1, ids.shape[1]) and int(deltas[0, 0]) == 0


@pytest.fixture(scope="module")
def disk_model(tmp_path_factory):
    """(config, weights, port model, processor) of a tiny gemma2 PaliGemma
    checkpoint on disk, loaded by `load_model` in f32 on the CPU, its
    processor by `processor_for`."""
    d = tmp_path_factory.mktemp("paligemma")
    cfg = tiny_paligemma_config(gemma2=True, image_token_index=250)
    w = paligemma_hf_weights(cfg, seed=11, scale=0.5)
    write_safetensors(d / "model.safetensors", w)
    (d / "config.json").write_text(json.dumps(cfg))
    tm = load_model(d, dtype=torch.float32, device="cpu")
    tp = processor_for(ByteTokenizer(dict(PALIGEMMA_SPECIAL_TOKENS,
                                          **{"<image>": 250}),
                                     "<eos>", "<pad>"), tm, d)
    return cfg, w, tm, tp


def test_stream_generate_on_checkpoint(disk_model):
    """A PaliGemma checkpoint on disk through `load_model`; `processor_for`
    gives it the PaliGemma processor (Gemma's special tokens, 4 image
    tokens at 28 / 14, BOS after them); greedy stream_generate on an image
    prompt gives the greedy tokens of the JAX package's unpadded forward
    on the same prompt."""
    cfg, w, tm, tp = disk_model
    assert isinstance(tp, PaliGemmaProcessor)
    assert (tp.image_token, tp.num_image_tokens, tp.bos_token) == (
        "<image>", 4, "<bos>")
    img = np.random.default_rng(1).integers(0, 256, (28, 28, 3),
                                            dtype=np.uint8)
    prompt = mlx_vlm_tpu_torch.apply_chat_template(tp, cfg, "caption en",
                                                   num_images=1)
    got = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
        tm, tp, prompt, image=img, max_tokens=4)]
    inputs = prepare_inputs(tp, prompt, images=img)
    assert inputs["input_ids"][0, :5].tolist() == [250] * 4 + [2]
    jm = jitted(jax_load(dict(cfg), w, jnp.float32))
    emb = jm.jit_embed(jm.params, jnp.asarray(inputs["input_ids"]),
                       jnp.asarray(inputs["pixel_values"]))
    logits, cache = _jax_forward(jm, emb, emb.shape[1] + 8)
    want = [int(np.argmax(logits[-1]))]
    for _ in range(3):
        lg, cache = jm.jit_call(jm.params, jm.language_model.embed(
            jm.params["language_model"], jnp.asarray([[want[-1]]])), cache,
            jnp.full((3, 1, 1), int(cache.offset), jnp.int32))
        want.append(int(np.argmax(np.asarray(lg)[0, -1])))
    assert got == want


def test_speculative_decoding_refuses_the_bidirectional_prefix(models):
    """A verify of k + 1 rows through PaliGemma's decoder would take the
    prefix's mask (no causal order among the drafts), as the reference's
    does: the port refuses such a target or drafter."""
    from mlx_vlm_tpu_torch.speculative.utils import \
        validate_drafter_compatibility
    from mlx_vlm_tpu_torch.utils.testing import (llama_hf_weights,
                                                 tiny_llama_config)

    _, tm, _ = models
    cfg = tiny_llama_config()
    drafter = load_model_from_weights(cfg, llama_hf_weights(cfg),
                                      torch.float32, "cpu")
    for pair in ((tm, drafter), (drafter, tm)):
        with pytest.raises(ValueError, match="bidirectional prefix"):
            validate_drafter_compatibility(*pair)
    validate_drafter_compatibility(drafter, drafter)
