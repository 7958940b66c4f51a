"""Port parity: the substrate that PaliGemma's decoder added, text-only
gemma / gemma2 (models/text_only.py on PaliGemma's decoder) and the
PaliGemma processor, against the JAX package (float32 on the CPU, the same
inputs from numpy seeds; the JAX side jitted) and transformers:

- the sliding `causal_cache_mask` and `full_valid_mask` exactly,
  `rms_norm(offset=1.0)` and `sdpa` with a soft-cap within 1e-6;
- every cache's `attend` with gemma2's soft-cap (and a window) within 1e-5
  of the JAX cache's, K6-K8 kept off under the soft-cap and taken without
  it;
- K6's plain version at PaliGemma-3B's decode shape (D = 256, G = 8, one
  KV head) against the Pallas kernel in interpret mode;
- text-only gemma and gemma2: the loader's dispatch, a causal prefill and
  decode steps past gemma2's window within 1e-4;
- a random 4-bit mlx checkpoint on disk (PaliGemma, text-only gemma /
  gemma2) through `mlx_vlm_tpu_torch.load` and the JAX package's loader:
  w8chan by default, exact and w8chan on request;
- `PaliGemmaProcessor` against transformers' PaliGemmaProcessor with its
  SiglipImageProcessor around one tokenizer built in memory: input ids,
  attention mask and pixel values exactly equal.
"""

import json
import os

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mlx_vlm_tpu.core import cache as jcache  # noqa: E402
from mlx_vlm_tpu.core import turboquant as jtq  # noqa: E402
from mlx_vlm_tpu.core.layers import rms_norm as jax_rms_norm  # noqa: E402
from mlx_vlm_tpu.core.mask import causal_cache_mask as jax_mask  # noqa: E402
from mlx_vlm_tpu.core.mask import full_valid_mask as jax_full_mask  # noqa
from mlx_vlm_tpu.ops.attention import sdpa as jax_sdpa  # noqa: E402
from mlx_vlm_tpu.ops.int4_kv_attention import \
    int4_kv_decode_attention as jax_k6  # noqa: E402
from mlx_vlm_tpu.utils.loader import \
    get_model_and_args as jax_model_and_args  # noqa: E402
from mlx_vlm_tpu.utils.loader import \
    load_model_from_weights as jax_load  # noqa: E402
from mlx_vlm_tpu.utils.loader import load_model as jax_load_model  # noqa
import mlx_vlm_tpu_torch  # noqa: E402
from mlx_vlm_tpu_torch.core import cache as tcache  # noqa: E402
from mlx_vlm_tpu_torch.core import turboquant as ttq  # noqa: E402
from mlx_vlm_tpu_torch.core.layers import rms_norm  # noqa: E402
from mlx_vlm_tpu_torch.core.mask import (causal_cache_mask,  # noqa: E402
                                         full_valid_mask)
from mlx_vlm_tpu_torch.core.quant import (  # noqa: E402
    ChannelQuantizedTensor, QuantizedTensor)
from mlx_vlm_tpu_torch.ops import int4_kv_attention as k6  # noqa: E402
from mlx_vlm_tpu_torch.ops import tq_kv_attention as tk  # noqa: E402
from mlx_vlm_tpu_torch.ops.attention import sdpa  # noqa: E402
from mlx_vlm_tpu_torch.utils.loader import (  # noqa: E402
    get_model_and_args, load_model_from_weights, params_from_jax,
    write_safetensors)
from mlx_vlm_tpu_torch.utils.processing import (  # noqa: E402
    PaliGemmaProcessor, SiglipImageProcessor)
from mlx_vlm_tpu_torch.utils.testing import (  # noqa: E402
    gemma_text_hf_weights, mlx_int4_checkpoint, paligemma_hf_weights,
    tiny_gemma_text_config, tiny_paligemma_config)
from test_torch_qwen2_5_vl import tree_equal  # noqa: E402

torch.set_num_threads(2)

@pytest.mark.parametrize("cursor", ["scalar", "rows"])
@pytest.mark.parametrize("window", [None, 3])
def test_masks_equal_reference(cursor, window):
    """The sliding causal mask and the prefix's validity mask, bit for bit,
    at a shared cursor and at per-row cursors with left padding."""
    lp = np.array([0, 2, 5], np.int32)
    off = np.int32(6) if cursor == "scalar" else np.array([6, 9, 3],
                                                          np.int32)
    for S in (1, 4):
        ref = np.asarray(jax_mask(jnp.asarray(off), jnp.asarray(lp), S, 16,
                                  window=window))
        got = causal_cache_mask(torch.from_numpy(np.asarray(off)),
                                torch.from_numpy(lp), S, 16, window=window)
        assert got.shape == ref.shape and np.array_equal(got.numpy(), ref)
    total = off + 4 if cursor == "scalar" else (off + 4)[:, None]
    ref = np.asarray(jax_full_mask(jnp.asarray(lp), jnp.asarray(total), 16))
    got = full_valid_mask(torch.from_numpy(lp),
                          torch.from_numpy(np.asarray(off + 4)), 16)
    assert np.array_equal(got.numpy(), ref)


def test_rms_norm_offset_and_sdpa_softcap():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal(48) * 0.1).astype(np.float32)
    ref = jax_rms_norm({"weight": jnp.asarray(w)}, jnp.asarray(x), 1e-6,
                       offset=1.0)
    got = rms_norm({"weight": torch.from_numpy(w)}, torch.from_numpy(x),
                   1e-6, offset=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    q = rng.standard_normal((1, 4, 6, 16)).astype(np.float32) * 8
    k = rng.standard_normal((1, 2, 10, 16)).astype(np.float32) * 8
    v = rng.standard_normal((1, 2, 10, 16)).astype(np.float32)
    m = np.array(jax_mask(jnp.asarray(4), jnp.zeros(1, jnp.int32), 6, 10,
                          window=3))
    ref = jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)), 0.25,
                   jnp.asarray(m), logit_softcap=5.0)
    got = sdpa(*(torch.from_numpy(a) for a in (q, k, v)), 0.25,
               torch.from_numpy(m), logit_softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    uncapped = sdpa(*(torch.from_numpy(a) for a in (q, k, v)), 0.25,
                    torch.from_numpy(m))
    assert not torch.allclose(got, uncapped, atol=1e-3)


C, CAP = 64, 5.0


def _caches(kind: str, D: int):
    """(JAX cache, port cache, a kernel wrapper the port must not call
    under a soft-cap or None) of one layer, B = 1, 2 KV heads."""
    lpj, lpt = jnp.asarray([3], jnp.int32), torch.tensor([3])
    if kind == "bf16":
        return (jcache.init_cache(1, 1, 2, D, C, jnp.float32, lpj),
                tcache.init_cache(1, 1, 2, D, C, torch.float32, lpt), None)
    if kind == "affine4":
        return (jcache.init_quantized_cache(1, 1, 2, D, C, jnp.float32, 4, 32,
                                            left_pad=lpj),
                tcache.init_quantized_cache(1, 1, 2, D, C, torch.float32, 4,
                                            32, left_pad=lpt), None)
    if kind == "int8":
        return (jcache.init_int8_cache(1, 1, 2, D, C, left_pad=lpj),
                tcache.init_int8_cache(1, 1, 2, D, C, left_pad=lpt), None)
    if kind == "int4":
        return (jcache.init_int4_cache(1, 1, 2, D, C, left_pad=lpj),
                tcache.init_int4_cache(1, 1, 2, D, C, left_pad=lpt),
                (k6, "int4_kv_decode_attention"))
    if kind == "rotated4":
        return (jtq.make_rotated_int4_cache(1, 1, 2, D, C, left_pad=lpj),
                ttq.make_rotated_int4_cache(1, 1, 2, D, C, left_pad=lpt),
                (k6, "int4_kv_decode_attention"))
    if kind == "turboquant":
        return (jtq.init_turboquant_cache(1, 1, 2, D, C, 3.5, left_pad=lpj),
                ttq.init_turboquant_cache(1, 1, 2, D, C, 3.5, left_pad=lpt),
                (tk, "tq_kv_decode_attention"))
    return (jtq.init_turboquant_split_cache(1, 1, 2, D, C, 3.5, left_pad=lpj),
            ttq.init_turboquant_split_cache(1, 1, 2, D, C, 3.5, left_pad=lpt),
            (tk, "tq_kv_decode_attention_split"))


@jax.jit
def _jax_attend(jc, q, k, v):
    """The JAX cache's attend on layer 0 with the soft-cap, `flash_ok`
    False and a window of 8 in the mask -> (out, the cache advanced)."""
    S = q.shape[2]
    m = jax_mask(jc.offset, jc.left_pad, S, C, window=8)
    cxs = tuple(a[0] for a in jc.scan_arrays())
    out, new = jc.attend(cxs, q, k, v, q.shape[-1]**-0.5, m, flash_ok=False,
                         logit_softcap=CAP)
    return out, jc.with_arrays(tuple(a[None] for a in new), S)


@pytest.mark.parametrize("kind", ["bf16", "affine4", "int8", "int4",
                                  "rotated4", "turboquant", "split"])
def test_cache_attend_with_softcap_matches_reference(kind, monkeypatch):
    """Every cache's attend with gemma2's soft-cap, `flash_ok=False` and a
    window of 8 in the mask: a 12-row prefill chunk then three decode
    steps, against the JAX cache's attend (the same plain route on both
    sides: the soft-cap keeps K6, K7 and K8 off, so the kernel wrapper is
    made to raise) within 1e-5 of max|ref|."""
    D = 64
    jc, tc_, kernel = _caches(kind, D)
    if kernel is not None:
        def refuse(*a, **k):
            raise AssertionError("a decode kernel ran under a soft-cap")

        monkeypatch.setattr(*kernel, refuse)
    rng = np.random.default_rng(len(kind))
    lp = np.array([3], np.int32)
    for s in (12, 1, 1, 1):
        q, k, v = (rng.standard_normal((1, n, s, D)).astype(np.float32) * 2
                   for n in (4, 2, 2))
        ref, jc = _jax_attend(jc, *(jnp.asarray(a) for a in (q, k, v)))
        tm = causal_cache_mask(tc_.offset, torch.from_numpy(lp), s, C,
                               window=8)
        got = tc_.attend(0, *(torch.from_numpy(a) for a in (q, k, v)),
                         D**-0.5, tm, flash_ok=False, logit_softcap=CAP)
        tc_.advance(s)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    if kernel is not None:  # without the soft-cap the decode step takes it
        monkeypatch.undo()
        calls = []
        real = getattr(*kernel)
        monkeypatch.setattr(*kernel, lambda *a, **k: calls.append(1)
                            or real(*a, **k))
        tc_.attend(0, *(torch.from_numpy(a) for a in (q, k, v)), D**-0.5,
                   tm)
        assert calls == [1]


def test_k6_plain_at_paligemma_decode_shape():
    """K6's plain version at PaliGemma-3B's decode step (8 query heads over
    one KV head of 256, kv_bits 4) against the Pallas kernel in interpret
    mode, at three cursors and with left padding.  Tolerance 1e-3 of
    max|ref|: both round p * vs to bf16; only f32 exp and sums differ."""
    BH, G, D, Cq = 1, 8, 256, 384
    rng = np.random.default_rng(27)
    qf = rng.standard_normal((BH, G, D)).astype(np.float32) * 4
    qs = np.abs(qf).max(-1) / 127.0
    q8 = np.round(qf / qs[..., None]).astype(np.int8)
    meta = np.stack([q8.astype(np.int32).sum(-1).astype(np.float32), qs],
                    -1).astype(np.float32)
    k4, v4 = (rng.integers(0, 256, (BH, Cq, D // 2), dtype=np.uint8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.05, 0.3, (BH, Cq)).astype(np.float32)
              for _ in range(2))
    kb, vb = (rng.uniform(-2, 0, (BH, Cq)).astype(np.float32)
              for _ in range(2))
    arrays = (q8, meta, k4, ks, kb, v4, vs, vb)
    for off, lp in ((1, 0), (300, 0), (300, 100)):
        ref = np.asarray(jax_k6(
            *(jnp.asarray(a) for a in arrays), jnp.asarray(off, jnp.int32),
            D**-0.5, left_pad=jnp.asarray([lp], jnp.int32), interpret=True))
        got = k6.int4_kv_decode_attention(
            *(torch.from_numpy(a) for a in arrays), off, D**-0.5,
            left_pad=torch.tensor([lp])).numpy()
        assert got.shape == ref.shape == (BH, G, D)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max())


# ------------------------------------------------------------ text only


@pytest.mark.parametrize("model_type", ["gemma", "gemma2"])
def test_text_only_dispatch_as_the_reference(model_type):
    cfg = {"model_type": model_type}
    arch, got = get_model_and_args(cfg)
    jarch, ref = jax_model_and_args(cfg)
    assert got == ref == model_type
    assert arch.__name__ == "mlx_vlm_tpu_torch.models.text_only"
    assert jarch.__name__ == "mlx_vlm_tpu.models.text_only"
    model = arch.Model(arch.ModelConfig.from_dict(
        tiny_gemma_text_config(gemma2=model_type == "gemma2")))
    assert not model.language_model.bidirectional


def _greedy_steps(jm, tm, ids, n_steps=6):
    """A causal prefill of `ids`, then n_steps greedy decode steps on the
    JAX package's tokens: (port logits, JAX logits), each [S + n, V]."""
    fwd = jax.jit(jm.__call__)
    S = ids.shape[1]
    jc = jm.language_model.init_cache(1, 32, jnp.float32)
    tc = tm.language_model.init_cache(1, 32, torch.float32)
    pos = np.broadcast_to(np.arange(S)[None, None], (3, 1, S))
    jl, jc = fwd(jm.params, jm.get_input_embeddings(
        jm.params, jnp.asarray(ids)), jc, jnp.asarray(pos, jnp.int32))
    tl = tm(tm.params, tm.get_input_embeddings(
        tm.params, torch.from_numpy(ids)), tc, torch.from_numpy(pos.copy()))
    ref, got = [np.asarray(jl)[0]], [tl[0].numpy()]
    for _ in range(n_steps):
        tok = [[int(np.argmax(ref[-1][-1]))]]
        p = int(jc.offset)
        jl, jc = fwd(jm.params, jm.get_input_embeddings(
            jm.params, jnp.asarray(tok)), jc,
            jnp.full((3, 1, 1), p, jnp.int32))
        tl = tm(tm.params, tm.get_input_embeddings(
            tm.params, torch.tensor(tok)), tc, torch.full((3, 1, 1), p))
        ref.append(np.asarray(jl)[0])
        got.append(tl[0].numpy())
    return np.concatenate(got), np.concatenate(ref)


@pytest.mark.parametrize("gemma2", [False, True])
def test_text_only_decoder_matches_reference(gemma2):
    """A text-only checkpoint through both loaders: the causal prefill (a
    later token does not move an earlier row) and 6 decode steps, past
    gemma2's window of 4, within 1e-4; params_from_jax equal to the
    port's own load."""
    cfg = tiny_gemma_text_config(gemma2=gemma2)
    w = gemma_text_hf_weights(cfg, 5)
    jm = jax_load(dict(cfg), dict(w), jnp.float32)
    tm = load_model_from_weights(cfg, dict(w), torch.float32, "cpu")
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    ids = np.array([[2, 17, 40, 99, 123, 7, 250]])
    got, ref = _greedy_steps(jm, tm, ids)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    ids2 = ids.copy()
    ids2[0, -1] = 11
    got2, _ = _greedy_steps(jm, tm, ids2, n_steps=0)
    np.testing.assert_array_equal(got2[:-1], got[:ids.shape[1] - 1])


def _write_mlx_checkpoint(path, cfg, weights):
    """An mlx 4-bit checkpoint on disk: its safetensors (the bf16 scales,
    biases and dense tensors as BF16), config.json and a tokenizer."""
    flat, bf16 = {}, []
    for k, v in weights.items():
        if isinstance(v, torch.Tensor):
            v, _ = v.view(torch.uint16).numpy(), bf16.append(k)
        flat[k] = v
    write_safetensors(path / "model.safetensors", flat, bf16=tuple(bf16))
    (path / "config.json").write_text(json.dumps(cfg))
    _hf_tokenizer().save_pretrained(str(path))


@pytest.mark.parametrize("kind,mode", [
    ("paligemma", None), ("paligemma", "exact"), ("paligemma", "w8chan"),
    ("gemma", None), ("gemma2", "exact")])
def test_load_mlx_checkpoint_on_disk(kind, mode, tmp_path, monkeypatch):
    """A random 4-bit mlx checkpoint on disk (PaliGemma with a gemma2 text
    model, or a text-only gemma / gemma2; the tied table quantized)
    through `mlx_vlm_tpu_torch.load` in the default mode (w8chan), exact
    and w8chan: each linear and the tied table in the mode's layout, the
    parameters equal to the JAX package's load of the same files
    (`params_from_jax`), the processor the family's, and greedy
    `generate` on it."""
    if mode:
        monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)
    if kind == "paligemma":
        cfg = tiny_paligemma_config(gemma2=True, projection_dim=128,
                                    image_token_index=3)
        cfg["text_config"].update(hidden_size=128, intermediate_size=256,
                                  vocab_size=400)
        cfg["vision_config"]["projection_dim"] = 128
    else:
        cfg = tiny_gemma_text_config(gemma2=kind == "gemma2",
                                     hidden_size=128, intermediate_size=256,
                                     vocab_size=400)
    cfg, w = mlx_int4_checkpoint(cfg, seed=8)
    _write_mlx_checkpoint(tmp_path, cfg, w)
    tm, proc = mlx_vlm_tpu_torch.load(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    lp = tm.params["language_model"]
    layout = QuantizedTensor if mode == "exact" else ChannelQuantizedTensor
    assert isinstance(lp["model"]["embed_tokens"]["weight"], layout)
    assert isinstance(lp["model"]["layers"]["mlp"]["down_proj"]["weight"],
                      layout)
    jm = jax_load_model(tmp_path, dtype=jnp.float32)
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    image = None
    if kind == "paligemma":
        assert isinstance(proc, PaliGemmaProcessor)
        assert (proc.image_token, proc.num_image_tokens) == ("<image>", 4)
        image = np.random.default_rng(0).integers(0, 256, (28, 28, 3),
                                                  dtype=np.uint8)
    prompt = mlx_vlm_tpu_torch.apply_chat_template(
        proc, tm.config_dict, "caption en", num_images=int(image is not None))
    out = mlx_vlm_tpu_torch.generate(tm, proc, prompt, image=image,
                                     max_tokens=3)
    assert out.generation_tokens == 3


# ------------------------------------------------------------ processor


def _hf_tokenizer():
    """A byte-level BPE trained in memory with Gemma's <pad>, <eos>, <bos>
    and PaliGemma's <image>, as transformers' GemmaTokenizerFast (left
    padding, as Gemma's)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers
    from transformers import GemmaTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    corpus = ["caption en", "answer en what is in the image",
              "describe the picture in detail", "detect cat ; dog"] * 8
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<pad>", "<eos>", "<bos>",
                                        "<image>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return GemmaTokenizerFast(tokenizer_object=tok, bos_token="<bos>",
                              eos_token="<eos>", pad_token="<pad>",
                              unk_token="<pad>", padding_side="left")


@pytest.mark.parametrize("texts,sizes", [
    (["caption en"], [(224, 224)]),
    (["<image>answer en what is in the image"], [(300, 200)]),
    (["caption en", "describe the picture in detail"], [(97, 121),
                                                        (224, 224)])])
def test_processor_matches_transformers(texts, sizes):
    """The numpy processor against transformers' PaliGemmaProcessor +
    SiglipImageProcessor (224, 256 image tokens), each around its own copy
    of one in-memory tokenizer: the prompt without <image> (image tokens,
    BOS, the prompt, "\n"), the prompt with it (BOS after the last image
    token), a left-padded batch; ids, mask and pixels exactly equal."""
    from transformers import PaliGemmaProcessor as HFProcessor
    from transformers import SiglipImageProcessor as HFImageProcessor

    hf = HFProcessor(image_processor=HFImageProcessor(image_seq_length=256),
                     tokenizer=_hf_tokenizer())
    mine = PaliGemmaProcessor(_hf_tokenizer(), SiglipImageProcessor(224))
    rng = np.random.default_rng(sum(sum(s) for s in sizes))
    imgs = [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in sizes]
    ref = hf(text=texts, images=imgs, padding=True, return_tensors="np")
    got = mine(text=texts, images=imgs, padding=True)
    for key in ("input_ids", "attention_mask", "pixel_values"):
        assert got[key].dtype == ref[key].dtype, key
        assert got[key].shape == ref[key].shape, key
        assert np.array_equal(got[key], ref[key]), key
    assert int((got["input_ids"] == 3).sum()) == 256 * len(texts)
    with pytest.raises(ValueError, match="images"):
        mine(text=texts)


def test_window_rule_matches_transformers():
    """PaliGemma-2's window against transformers' PaliGemma with a Gemma-2
    text model (eager attention, the same weights): a 10-token image
    prompt with window 4, prefilled (the window ignored within the prefix
    in both), then 6 decode steps past the window, within 1e-5 of
    max|ref|.  transformers' PaliGemmaForConditionalGeneration leaves out
    gemma2's final soft-cap, which the reference applies (ROADMAP), so its
    logits are capped here before the comparison."""
    from transformers import PaliGemmaConfig, PaliGemmaForConditionalGeneration

    cfg = tiny_paligemma_config(gemma2=True)
    w = paligemma_hf_weights(cfg, 3, scale=0.2)
    hf_cfg = PaliGemmaConfig(
        text_config=dict(cfg["text_config"], max_position_embeddings=256),
        vision_config=dict(cfg["vision_config"], vision_use_head=False,
                           layer_norm_eps=1e-6),
        image_token_index=64, projection_dim=48, vocab_size=256)
    hf_cfg._attn_implementation = hf_cfg.text_config._attn_implementation = \
        "eager"
    hf = PaliGemmaForConditionalGeneration(hf_cfg).eval()
    state = {"model." + k.replace("language_model.model.",
                                  "language_model."): torch.from_numpy(v)
             for k, v in w.items()}
    state["lm_head.weight"] = state["model.language_model.embed_tokens.weight"]
    hf.load_state_dict(state)
    port = load_model_from_weights(cfg, dict(w), torch.float32, "cpu")
    ids = torch.tensor([[64] * 4 + [2, 70, 80, 90, 100, 110]])
    pix = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (1, 3, 28, 28)) * 0.5).astype(np.float32))

    def capped(logits):
        return (torch.tanh(logits / 30.0) * 30.0).numpy()

    with torch.no_grad():
        out = hf(input_ids=ids, pixel_values=pix, use_cache=True)
        cache = port.language_model.init_cache(1, 32, torch.float32)
        got = port(port.params, port.get_input_embeddings(
            port.params, ids, pix), cache, torch.arange(10).expand(3, 1, -1))
        ref = capped(out.logits[0])
        np.testing.assert_allclose(got[0].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        pkv, tok = out.past_key_values, int(ref[-1].argmax())
        for pos in range(10, 16):
            out = hf(input_ids=torch.tensor([[tok]]), past_key_values=pkv,
                     use_cache=True, cache_position=torch.tensor([pos]),
                     attention_mask=torch.ones((1, pos + 1), dtype=torch.long))
            pkv, ref = out.past_key_values, capped(out.logits[0, -1])
            got = port(port.params, port.get_input_embeddings(
                port.params, torch.tensor([[tok]])), cache,
                torch.full((3, 1, 1), pos))[0, -1].numpy()
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())
            tok = int(ref.argmax())
