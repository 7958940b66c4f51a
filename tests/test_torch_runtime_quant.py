"""Port parity: the runtime quantization modes and the group-affine KV cache.

MLX_VLM_TPU_RUNTIME_QUANT picks how mlx group-affine checkpoints run:
"w4grp" (halves-packed int4), "w8chan" (per-channel int8, the default for
8-bit checkpoints) and "exact" (the checkpoint's codes as they are, through
K5).  The port's mode rule, fold, layer stacking and `params_from_jax` are
held to the JAX package's loader byte for byte; tiny Qwen2-VL slices in the
exact-4, exact-8 and w8chan-8 layouts are held to the JAX model (f32, both
loaded through `load_model_from_weights`) on teacher-forced logits and
greedy tokens; the group-affine QuantizedKVCache (kv_bits 8 and 4 with
MLX_VLM_TPU_KV_SCHEME=affine, and 2) is held to the reference's cache on its
buffers and on logits.  Inputs come from numpy with a seed; everything runs
in float32 on the CPU.
"""

import dataclasses
import functools
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from mlx_vlm_tpu.core import cache as jcache
from mlx_vlm_tpu.core.mask import causal_cache_mask as jax_mask
from mlx_vlm_tpu.utils import loader as jl
from mlx_vlm_tpu_torch.core import cache as tcache
from mlx_vlm_tpu_torch.core import quant as tq
from mlx_vlm_tpu_torch.core.mask import causal_cache_mask
from mlx_vlm_tpu_torch.ops import qmatmul as k5
from mlx_vlm_tpu_torch.utils import loader as tl
from mlx_vlm_tpu_torch.utils.testing import (mlx_int4_checkpoint,
                                             mlx_quantized_checkpoint,
                                             tiny_qwen2_vl_config)

torch.set_num_threads(2)


def _jax_leaf(v):
    """A port host leaf as the JAX package reads it (bf16 via ml_dtypes)."""
    if isinstance(v, torch.Tensor):
        return v.float().numpy().astype(ml_dtypes.bfloat16)
    return v


def _set_mode(mp, mode):
    if mode is None:
        mp.delenv("MLX_VLM_TPU_RUNTIME_QUANT", raising=False)
    else:
        mp.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)


def _array_like(v):
    return isinstance(v, (torch.Tensor, np.ndarray, jax.Array))


def _walk_same(ref, got, path="params"):
    """Equal keys, equal container types and metadata, and arrays equal byte
    for byte (floats compared as exactly widened float32, dtype names
    equal)."""
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(got), path
        for k in ref:
            _walk_same(ref[k], got[k], f"{path}.{k}")
    elif _array_like(ref):
        assert _array_like(got), path
        assert tq.dtype_name(ref) == tq.dtype_name(got), path
        r, g = tq.host_array(ref), tq.host_array(got)
        assert r.shape == g.shape and np.array_equal(r, g), path
    elif dataclasses.is_dataclass(ref):
        assert type(ref).__name__ == type(got).__name__, path
        for f in dataclasses.fields(ref):
            _walk_same(getattr(ref, f.name), getattr(got, f.name),
                       f"{path}.{f.name}")
    else:
        assert ref == got, path


# ---------------------------------------------------------- the mode rule


@pytest.mark.parametrize("mode", [None, "", "w4grp", "w8chan", "exact",
                                  "int3"])
def test_runtime_quant_mode_matches_reference(monkeypatch, mode):
    _set_mode(monkeypatch, mode)
    for default in ("w8chan", "w4grp", "exact"):
        try:
            want = jl.runtime_quant_mode(default)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                tl.runtime_quant_mode(default)
            assert str(got.value) == str(exc)
            continue
        assert tl.runtime_quant_mode(default) == want


# ------------------------------------------------- fold, stack, load


def _models(cfg):
    from mlx_vlm_tpu.models import qwen2_vl as jarch
    from mlx_vlm_tpu_torch.models import qwen2_vl as tarch

    return (jarch.Model(jarch.ModelConfig.from_dict(cfg)),
            tarch.Model(tarch.ModelConfig.from_dict(cfg)))


@pytest.mark.parametrize("mode", ["w4grp", "w8chan", "exact"])
@pytest.mark.parametrize("bits,g", [(4, 32), (8, 64)])
def test_fold_and_stack_match_reference(monkeypatch, bits, g, mode):
    """`_fold_quantized` then `_stack_layers` on the same flat checkpoint:
    the same keys, container types and bytes (codes, int8 codes, scales,
    biases, the embedding table and lm_head included)."""
    _set_mode(monkeypatch, mode)
    cfg, w = mlx_quantized_checkpoint(tiny_qwen2_vl_config(), bits=bits,
                                      group_size=g, seed=bits)
    jm, tm = _models(cfg)
    qcfg = cfg["quantization"]
    ref = jl._stack_layers(
        jl._fold_quantized(jm.sanitize({k: _jax_leaf(v) for k, v in w.items()}),
                           qcfg), tuple(jm.stack_patterns))
    got = tl._stack_layers(tl._fold_quantized(tm.sanitize(dict(w)), qcfg),
                           tuple(tm.stack_patterns))
    assert sorted(ref) == sorted(got)
    kinds = {type(v).__name__ for v in got.values()}
    want = {"w4grp": {"Int4GroupedTensor", "ChannelQuantizedTensor"},
            "w8chan": {"ChannelQuantizedTensor"},
            "exact": {"QuantizedTensor"}}[mode]
    if bits == 8 and mode == "w4grp":
        want = {"ChannelQuantizedTensor"}
    assert want <= kinds
    emb = got["language_model.model.embed_tokens.weight"]
    assert type(emb).__name__ == ("QuantizedTensor" if mode == "exact"
                                  else "ChannelQuantizedTensor")
    for k in ref:
        _walk_same(ref[k], got[k], k)


@pytest.mark.parametrize("g", [8, 24, 16, 48])
def test_w4grp_fold_takes_k1_k2_group_sizes(g):
    """K1 and K2 take group sizes that are multiples of 16; the reference's
    w4grp rule repacks any g with whole groups a row.  The port's fold
    makes a 4-bit linear of group 8 or 24 per-channel int8 instead, byte
    for byte the JAX package's w8chan fold of the same triple, whose
    product matches that layout's plain version; g = 16 and 48 stay
    w4grp, equal to the reference's repack."""
    rng = np.random.default_rng(g)
    N, K = 64, 96
    w = rng.integers(0, 2**32, (N, K * 4 // 32), dtype=np.uint32)
    s = rng.uniform(1e-3, 2e-3, (N, K // g)).astype(np.float32)
    b = (-7.5 * s).astype(np.float32)
    got = tl._fold_triple(w, torch.from_numpy(s), torch.from_numpy(b), 4, g,
                          "w4grp", False)
    want_mode = "w4grp" if g % 16 == 0 else "w8chan"
    ref = jl._fold_quantized(
        {"x.weight": w, "x.scales": s, "x.biases": b},
        {"bits": 4, "group_size": g}, want_mode)["x.weight"]
    kind = "Int4GroupedTensor" if g % 16 == 0 else "ChannelQuantizedTensor"
    assert type(got).__name__ == type(ref).__name__ == kind
    _walk_same(ref, got)
    if g % 16:
        x = torch.from_numpy(rng.standard_normal((3, K)).astype(np.float32))
        y = tq.channel_quantized_matmul(x, got)
        dense = (got.q8.float() * got.scales.float() + got.biases.float())
        np.testing.assert_allclose(y.numpy(), (x @ dense).numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", [None, "w8chan", "exact"])
@pytest.mark.parametrize("bits,g", [(4, 32), (8, 64)])
def test_load_and_params_from_jax_match_reference(monkeypatch, bits, g, mode):
    """Both loaders on the same checkpoint in f32 (unset: the reference's
    default, w4grp for 4 bits and w8chan for 8): the port's parameters equal
    `params_from_jax` of the reference's tree, leaf types included, and the
    fused decode route is off except for a w4grp load."""
    _set_mode(monkeypatch, mode)
    monkeypatch.setenv("MLX_VLM_TPU_FUSED_DECODE", "0")
    cfg, w = mlx_quantized_checkpoint(tiny_qwen2_vl_config(), bits=bits,
                                      group_size=g, seed=bits + 1)
    jm = jl.load_model_from_weights(
        dict(cfg), {k: _jax_leaf(v) for k, v in w.items()}, jnp.float32)
    tm = tl.load_model_from_weights(cfg, w, torch.float32, "cpu")
    ref = tl.params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    _walk_same(ref, tm.params)
    lin = tm.params["language_model"]["model"]["layers"]["mlp"]["up_proj"][
        "weight"]
    expect = {"exact": tq.QuantizedTensor, "w8chan": tq.ChannelQuantizedTensor,
              None: tq.Int4GroupedTensor if bits == 4
              else tq.ChannelQuantizedTensor}[mode]
    assert isinstance(lin, expect)
    monkeypatch.delenv("MLX_VLM_TPU_FUSED_DECODE")
    assert tl.decide_fused_decode(tm) == (expect is tq.Int4GroupedTensor)


def test_int4_checkpoint_is_the_4bit_case():
    """`mlx_int4_checkpoint` is a thin call of `mlx_quantized_checkpoint`
    and draws the same bytes as before it was (the digest below is that of
    the 4-bit-only version of the function)."""
    cfg0 = tiny_qwen2_vl_config()
    cfg, w = mlx_int4_checkpoint(cfg0, seed=3, group_size=32)
    cfg2, w2 = mlx_quantized_checkpoint(cfg0, bits=4, group_size=32, seed=3)
    assert cfg == cfg2 and list(w) == list(w2)
    h = hashlib.sha256()
    for k in sorted(w):
        v = w[k]
        a = v.view(torch.int16).numpy() if isinstance(v, torch.Tensor) else v
        assert np.array_equal(a, w2[k].view(torch.int16).numpy()
                              if isinstance(w2[k], torch.Tensor) else w2[k])
        h.update(k.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    assert h.hexdigest() == ("d7b3c7f9a136d8ed419d17c7b9608df5"
                             "5b53d32603b985606f8d89fec0ca91bc")
    assert cfg["quantization"] == {"group_size": 32, "bits": 4}


def test_8bit_checkpoint_layout():
    cfg, w = mlx_quantized_checkpoint(tiny_qwen2_vl_config(), bits=8,
                                      group_size=64, seed=0)
    q = w["model.layers.0.mlp.down_proj.weight"]
    assert q.dtype == np.uint32 and q.shape == (64, 128 // 4)
    s = w["model.layers.0.mlp.down_proj.scales"].float()
    b = w["model.layers.0.mlp.down_proj.biases"].float()
    assert s.shape == (64, 2)
    # both are bf16 roundings of f32 values: equal within 2 bf16 ulps
    torch.testing.assert_close(b, -127.5 * s, rtol=2.0**-7, atol=0)
    codes = q.view(np.uint8)
    assert codes.min() == 0 and codes.max() == 255
    assert cfg["quantization"] == {"group_size": 64, "bits": 8}


# ------------------------------------------------------------ the slices

# (bits, group size, MLX_VLM_TPU_RUNTIME_QUANT): exact-4 at g = 32 (so that
# the 64-wide hidden state is K5-eligible: K/2 % g == 0), exact-8 and the
# 8-bit default, w8chan
SLICES = {"exact4": (4, 32, "exact"), "exact8": (8, 64, "exact"),
          "w8chan8": (8, 64, None)}
N_STEPS = 6


def _slice_config():
    """Tiny Qwen2-VL with Qwen2-VL's vocabulary and special ids, so the
    byte-level tokenizer's ids are in range."""
    return tiny_qwen2_vl_config(vocab_size=152064, image_token_id=151655,
                                video_token_id=151656,
                                vision_start_token_id=151652)


@functools.lru_cache(maxsize=None)
def _slice(name):
    bits, g, mode = SLICES[name]
    cfg, w = mlx_quantized_checkpoint(_slice_config(), bits=bits,
                                      group_size=g, seed=11)
    mp = pytest.MonkeyPatch()
    _set_mode(mp, mode)
    try:
        jm = jl.load_model_from_weights(
            dict(cfg), {k: _jax_leaf(v) for k, v in w.items()}, jnp.float32)
        tm = tl.load_model_from_weights(cfg, w, torch.float32, "cpu")
    finally:
        mp.undo()
    return jm, tm, cfg


@pytest.fixture(scope="module", params=list(SLICES))
def slice_models(request):
    return (request.param, *_slice(request.param))


def _processors():
    from mlx_vlm_tpu.utils.processing import Qwen2VLImageProcessor as JIP
    from mlx_vlm_tpu.utils.processing import Qwen2VLProcessor as JP
    from mlx_vlm_tpu_torch.utils.processing import (Qwen2VLImageProcessor,
                                                    Qwen2VLProcessor)
    from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

    return (JP(ByteTokenizer(), JIP()),
            Qwen2VLProcessor(ByteTokenizer(), Qwen2VLImageProcessor()))


IMAGE = np.random.default_rng(4).integers(0, 256, (56, 84, 3), dtype=np.uint8)


def _prompt(cfg, text, n_img):
    from mlx_vlm_tpu_torch import apply_chat_template

    return apply_chat_template(_processors()[1], cfg, text, num_images=n_img)


def _f32_bound(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


def test_slice_layouts(slice_models):
    name, _, tm, _ = slice_models
    lp = tm.params["language_model"]
    kind = (tq.ChannelQuantizedTensor if name == "w8chan8"
            else tq.QuantizedTensor)
    for w in (lp["model"]["layers"]["self_attn"]["q_proj"]["weight"],
              lp["model"]["layers"]["mlp"]["down_proj"]["weight"],
              lp["lm_head"]["weight"], lp["model"]["embed_tokens"]["weight"]):
        assert isinstance(w, kind)
    layer = lp["model"]["layers"]["mlp"]["down_proj"]["weight"].layer(1)
    assert layer.ndim == 2
    if kind is tq.QuantizedTensor:
        assert layer.bits == SLICES[name][0]
        assert tq.qmm_kernel_route(layer)
    assert not tm.language_model.fused_decode


def _jax_forced(jm, inputs, n_steps, kv_bits=None, kv_group_size=64):
    """The reference's logits along its greedy path (one prefill chunk,
    then decode steps) and its final cache."""
    from mlx_vlm_tpu.generate.ar import make_cache

    ids = inputs["input_ids"]
    lm, lp = jm.language_model, jm.params["language_model"]
    if "pixel_values" in inputs:
        aux = {k: jnp.asarray(v) for k, v in
               jm.vision_aux_inputs(inputs["image_grid_thw"]).items()}
        e = jm.get_input_embeddings(jm.params, jnp.asarray(ids),
                                    jnp.asarray(inputs["pixel_values"]), **aux)
        pos, deltas = jm.prepare_position_ids(ids, inputs["image_grid_thw"])
    else:
        e = lm.embed(lp, jnp.asarray(ids))
        pos, deltas = jm.prepare_position_ids(ids, None)
    cache = make_cache(jm, 1, 128, jnp.float32, kv_bits, kv_group_size)
    logits, cache = jm(jm.params, e, cache, jnp.asarray(pos))
    out, toks = [np.asarray(logits[0, -1])], []
    for _ in range(n_steps - 1):
        toks.append(int(np.argmax(out[-1])))
        p = jnp.full((3, 1, 1), int(cache.offset) + int(deltas[0, 0]),
                     jnp.int32)
        logits, cache = jm(jm.params, lm.embed(lp, jnp.asarray([[toks[-1]]])),
                           cache, p)
        out.append(np.asarray(logits[0, 0]))
    return np.stack(out), toks, cache


def _port_forced(tm, inputs, toks, kv_bits=None, kv_group_size=64):
    from mlx_vlm_tpu_torch.generate.ar import make_cache

    ids = torch.from_numpy(inputs["input_ids"].astype(np.int64))
    lm, lp = tm.language_model, tm.params["language_model"]
    if "pixel_values" in inputs:
        aux = tm.vision_aux_inputs(inputs["image_grid_thw"])
        e = tm.get_input_embeddings(
            tm.params, ids, torch.from_numpy(inputs["pixel_values"]),
            **{k: torch.from_numpy(v) for k, v in aux.items()})
        pos, deltas = tm.prepare_position_ids(inputs["input_ids"],
                                              inputs["image_grid_thw"])
    else:
        e = lm.embed(lp, ids)
        pos, deltas = tm.prepare_position_ids(inputs["input_ids"], None)
    cache = make_cache(tm, 1, 128, torch.float32, kv_bits, kv_group_size)
    out = [tm(tm.params, e, cache, torch.from_numpy(pos.astype(np.int64)))[
        0, -1].numpy()]
    for tok in toks:
        p = torch.full((3, 1, 1), int(cache.offset) + int(deltas[0, 0]))
        out.append(tm(tm.params, lm.embed(lp, torch.tensor([[tok]])), cache,
                      p)[0, 0].numpy())
    return np.stack(out), cache


def _count_plain(monkeypatch):
    calls = {"n": 0}
    plain = k5.qmatmul_plain

    def counted(x, t):
        calls["n"] += 1
        return plain(x, t)

    monkeypatch.setattr(k5, "qmatmul_plain", counted)
    return calls


def test_slice_teacher_forced_logits(slice_models, monkeypatch):
    """Prefill with one image, then decode steps fed the reference's greedy
    tokens: every step's logits within 1e-4 * max(1, max|ref|) (f32 on both
    sides; they differ by summation order only).  The exact slices run
    every linear and the head through K5's plain version: 7 per layer and
    one head per step; w8chan runs none."""
    name, jm, tm, cfg = slice_models
    jp, tp = _processors()
    prompt = _prompt(cfg, "What is in this image?", 1)
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    inputs = prepare_inputs(tp, prompt, images=IMAGE)
    ref, toks, _ = _jax_forced(jm, inputs, N_STEPS)
    calls = _count_plain(monkeypatch)
    before = dict(k5.launches)
    got, cache = _port_forced(tm, inputs, toks)
    assert int(cache.offset) == inputs["input_ids"].shape[1] + N_STEPS - 1
    assert np.abs(got - ref).max() <= _f32_bound(ref)
    L = cfg["num_hidden_layers"]
    want = 0 if name == "w8chan8" else N_STEPS * (7 * L + 1)
    assert calls["n"] == want
    assert k5.launches == before


@pytest.mark.parametrize("with_image", [True, False])
def test_slice_stream_generate_matches(slice_models, with_image):
    """Greedy tokens through each package's stream_generate are equal."""
    from mlx_vlm_tpu.generate.dispatch import stream_generate as jax_stream
    from mlx_vlm_tpu_torch.generate.dispatch import stream_generate

    name, jm, tm, cfg = slice_models
    jp, tp = _processors()
    text = "Describe this image." if with_image else "Tell me a story."
    prompt = _prompt(cfg, text, int(with_image))
    image = IMAGE if with_image else None
    jt = [r.token for r in jax_stream(jm, jp, prompt, image=image,
                                      max_tokens=N_STEPS,
                                      prefill_step_size=64)]
    tt = [r.token for r in stream_generate(tm, tp, prompt, image=image,
                                           max_tokens=N_STEPS,
                                           prefill_step_size=64)]
    assert len(tt) >= 1 and tt == jt


# --------------------------------------------------- the group-affine cache

# (kv_bits, MLX_VLM_TPU_KV_SCHEME)
AFFINE_CASES = [(8, "affine"), (4, "affine"), (2, None)]
FIELDS = ("kq", "ks", "kb", "vq", "vs", "vb")


def _set_kv_scheme(mp, scheme):
    if scheme is None:
        mp.delenv("MLX_VLM_TPU_KV_SCHEME", raising=False)
    else:
        mp.setenv("MLX_VLM_TPU_KV_SCHEME", scheme)


def _buffers_equal(jax_cache, port_cache, rel=0.0):
    """Codes equal byte for byte; scales and biases equal, or within `rel`
    of max|ref| where the two caches were fed k/v that differ in the last
    f32 bits."""
    for j, f in zip(jax_cache.scan_arrays(), FIELDS):
        ref = np.asarray(j)
        got = getattr(port_cache, f).numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, f
        if ref.dtype == np.uint8 or rel == 0.0:
            assert np.array_equal(got.view(np.uint8), ref.view(np.uint8)), f
        else:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("kv_bits,scheme", AFFINE_CASES)
def test_quantized_kv_cache_matches_reference(kv_bits, scheme):
    """One layer's attend through both caches: a 40-token prefill, then two
    decode steps; the outputs within 1e-5 * max|ref| (the same f32 math) and
    the written buffers equal."""
    D, nh, nkv, C, lp = 128, 4, 2, 256, 3
    j = jcache.init_quantized_cache(1, 1, nkv, D, C, jnp.float32,
                                    bits=kv_bits, group_size=64,
                                    left_pad=jnp.asarray([lp], jnp.int32))
    t = tcache.init_quantized_cache(1, 1, nkv, D, C, torch.float32,
                                    bits=kv_bits, group_size=64,
                                    left_pad=torch.tensor([lp]))
    rng = np.random.default_rng(kv_bits)
    for s in (40, 1, 1):
        q, k, v = (rng.standard_normal((1, h, s, D)).astype(np.float32)
                   for h in (nh, nkv, nkv))
        lpa = np.array([lp], np.int32)
        jm = jax_mask(j.offset, jnp.asarray(lpa), s, C)
        cxs = tuple(a[0] for a in j.scan_arrays())
        ref, new = j.attend(cxs, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), D ** -0.5, jm)
        j = j.with_arrays(tuple(a[None] for a in new), s)
        got = t.attend(0, torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), D ** -0.5,
                       causal_cache_mask(t.offset, torch.from_numpy(lpa), s,
                                         C))
        t.advance(s)
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        _buffers_equal(j, t)
    assert int(t.offset) == int(j.offset) == 42


@pytest.mark.parametrize("kv_bits,scheme", AFFINE_CASES)
def test_quantized_kv_slice_matches_reference(monkeypatch, kv_bits, scheme):
    """The exact-8 slice (head dim 16, kv_group_size 16) with kv_bits: both
    packages build a QuantizedKVCache; teacher-forced logits within the f32
    bound.  After the last step the caches hold the same codes, and scales
    and biases within 1e-6 * max|ref|: the k/v the two models write differ
    by f32 summation order (about 3e-7 relative here), which the
    per-group min and (max - min) / levels carry over."""
    _set_kv_scheme(monkeypatch, scheme)
    jm, tm, cfg = _slice("exact8")
    ids = np.array([[int(t) for t in np.random.default_rng(6).integers(
        0, 256, 23)]], np.int64)
    inputs = {"input_ids": ids}
    ref, toks, jc = _jax_forced(jm, inputs, N_STEPS, kv_bits, 16)
    got, tc = _port_forced(tm, inputs, toks, kv_bits, 16)
    assert type(jc).__name__ == type(tc).__name__ == "QuantizedKVCache"
    assert tc.bits == jc.bits == kv_bits and tc.group_size == 16
    assert np.abs(got - ref).max() <= _f32_bound(ref)
    assert int(tc.offset) == int(jc.offset) == ids.shape[1] + N_STEPS - 1
    _buffers_equal(jc, tc, rel=1e-6)
