"""Port parity: the quantized KV caches and the Qwen2-VL slice with kv_bits.

K6's plain version is held to the Pallas kernel in interpret mode, the
int8 / int4 caches to the reference's `attend`, `make_cache` to the
reference's decision tree, and the whole slice (tiny Qwen2-VL with head
dim 128) to the JAX package for kv_bits 8, 4, 3.5 and 3.5 split.  Inputs
are made with numpy from a seed and handed to both packages; both run in
float32 on the CPU.  Tests marked `cuda` hold the CUDA kernel K6 to its
plain version on a GPU and skip without one.  K6's host plan, its mirror
of the kernel's shared-memory layout, and plain emulations of the kernel's
key and value slot orders run on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.core import cache as jcache
from mlx_vlm_tpu.core import turboquant as jtq
from mlx_vlm_tpu.core.mask import causal_cache_mask as jax_mask
from mlx_vlm_tpu.ops.int4_kv_attention import M_ROWS
from mlx_vlm_tpu.ops.int4_kv_attention import (
    int4_kv_decode_attention as jax_k6)
from mlx_vlm_tpu_torch.core import cache as tcache
from mlx_vlm_tpu_torch.core import turboquant as ttq
from mlx_vlm_tpu_torch.core.mask import causal_cache_mask
from mlx_vlm_tpu_torch.ops import int4_kv_attention as k6

torch.set_num_threads(2)

G, BH, C = 7, 3, 256
# per-row cursors: row 1 sees only [5, 37); row 2 sees nothing
ROW_OFFSETS = np.array([200, 37, 100], np.int32)
ROW_LEFT_PAD = np.array([0, 5, 100], np.int32)


def k6_inputs(D, seed, q_scale=1.0):
    """Random K6 inputs: int8 query codes of g rows, 4-bit codes and scales
    over the whole capacity (so the columns past each cursor are garbage
    the kernel must not read)."""
    rng = np.random.default_rng(seed)
    qf = rng.standard_normal((BH, G, D)).astype(np.float32) * q_scale
    qs = np.abs(qf).max(-1) / 127.0
    q8 = np.round(qf / qs[..., None]).astype(np.int8)
    meta = np.stack([q8.astype(np.int32).sum(-1).astype(np.float32), qs],
                    -1).astype(np.float32)
    k4, v4 = (rng.integers(0, 256, (BH, C, D // 2), dtype=np.uint8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.05, 0.3, (BH, C)).astype(np.float32)
              for _ in range(2))
    kb, vb = (rng.uniform(-2, 0, (BH, C)).astype(np.float32)
              for _ in range(2))
    return q8, meta, k4, ks, kb, v4, vs, vb


def pad_rows(a, value=0):
    """The JAX kernels take M_ROWS = 8 query rows per KV head."""
    return np.pad(a, ((0, 0), (0, M_ROWS - a.shape[1]), (0, 0)),
                  constant_values=value)


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_k6_plain_matches_pallas(D, rows):
    """Tolerance 1e-3 * max|ref|: the scores are exact integers in both;
    what differs is the f32 exp and sums, which can flip the bf16 rounding
    of a single p * vs term (2**-9 of it)."""
    q8, meta, k4, ks, kb, v4, vs, vb = k6_inputs(D, seed=D)
    scale = D ** -0.5
    if rows == "scalar":
        off, lp = np.int32(150), np.full((BH,), 20, np.int32)
    else:
        off, lp = ROW_OFFSETS, ROW_LEFT_PAD
    ref = np.asarray(jax_k6(
        jnp.asarray(pad_rows(q8)), jnp.asarray(pad_rows(meta, 1.0)),
        *(jnp.asarray(a) for a in (k4, ks, kb, v4, vs, vb)),
        jnp.asarray(off), scale, left_pad=jnp.asarray(lp),
        interpret=True))[:, :G]
    got = k6.int4_kv_decode_attention(
        *(torch.from_numpy(a) for a in (q8, meta, k4, ks, kb, v4, vs, vb)),
        int(off) if rows == "scalar" else torch.from_numpy(off), scale,
        left_pad=torch.from_numpy(lp)).numpy()
    assert got.shape == (BH, G, D)
    if rows == "per_row":
        assert not got[2].any() and not ref[2].any()  # sees nothing -> 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max())


# ------------------------------------------------------------ the caches


def _jax_attend(cache, q, k, v, mask):
    """One reference attend on layer 0 -> (out, cache with the new arrays)."""
    cxs = tuple(a[0] for a in cache.scan_arrays())
    out, new = cache.attend(cxs, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), q.shape[-1] ** -0.5, mask)
    return np.asarray(out), cache.with_arrays(tuple(a[None] for a in new),
                                              k.shape[2])


def cache_steps(jax_cache, port_cache, D, nh=4, nkv=2, S=40, seed=0,
                left_pad=3):
    """Prefill S tokens, then two decode steps, through both caches' attend;
    returns [(port out, reference out)] and the two final caches."""
    rng = np.random.default_rng(seed)
    outs = []
    for s in (S, 1, 1):
        q = rng.standard_normal((1, nh, s, D)).astype(np.float32)
        k = rng.standard_normal((1, nkv, s, D)).astype(np.float32)
        v = rng.standard_normal((1, nkv, s, D)).astype(np.float32)
        lp = np.array([left_pad], np.int32)
        jm = jax_mask(jax_cache.offset, jnp.asarray(lp), s,
                      jax_cache.capacity)
        ref, jax_cache = _jax_attend(jax_cache, q, k, v, jm)
        tm = causal_cache_mask(port_cache.offset, torch.from_numpy(lp), s,
                               port_cache.capacity)
        got = port_cache.attend(0, torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), D ** -0.5, tm)
        port_cache.advance(s)
        outs.append((got.numpy(), ref))
    return outs, jax_cache, port_cache


def _buffers_equal(jax_cache, port_cache, fields):
    """Codes equal, scales and biases within 1e-6 relative."""
    for j, f in zip(jax_cache.scan_arrays(), fields):
        ref = np.asarray(j)
        got = getattr(port_cache, f).numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, f
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        else:
            assert np.array_equal(got, ref), f


# Output tolerances, relative to max|ref| of each step.  PREFILL: the same
# f32 math on both sides (float order only).  ROUNDED: the port's decode
# runs K6, which rounds p * vs to bf16 (2**-9 relative), where the
# reference's XLA route does not round; the rounded sum  sum p*vs*code
# carries the bias -min, so it is several times the output it cancels down
# to, and the error it leaves measures 1-2% of max|ref| here.  PALLAS: both
# sides round p * vs to bf16 (the reference's kernel at D = 256); only f32
# exp and sums differ.
PREFILL, ROUNDED, PALLAS = 1e-5, 3e-2, 1e-3


def _check_outputs(outs, decode_tol):
    for (got, ref), tol in zip(outs, (PREFILL, decode_tol, decode_tol)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("bits,D,decode_tol", [(8, 128, PREFILL),
                                               (4, 128, ROUNDED),
                                               (4, 256, PALLAS)])
def test_int_caches_match_reference(bits, D, decode_tol):
    """Int8KVCache and Int4KVCache against the reference's attend, prefill
    then decode; written buffers equal.  Int8 runs the same math on both
    sides.  At D = 128 the reference's int4 decode takes its XLA route and
    at D = 256 its Pallas kernel; the port's decode runs K6 in both."""
    nkv = 2
    if bits == 8:
        j = jcache.init_int8_cache(1, 1, nkv, D, C,
                                   left_pad=jnp.asarray([3], jnp.int32))
        t = tcache.init_int8_cache(1, 1, nkv, D, C,
                                   left_pad=torch.tensor([3]))
        fields = ("k8", "ks", "kb", "v8", "vs", "vb")
    else:
        j = jcache.init_int4_cache(1, 1, nkv, D, C,
                                   left_pad=jnp.asarray([3], jnp.int32))
        t = tcache.init_int4_cache(1, 1, nkv, D, C,
                                   left_pad=torch.tensor([3]))
        fields = ("k4", "ks", "kb", "v4", "vs", "vb")
    outs, j, t = cache_steps(j, t, D, seed=bits + D)
    assert int(t.offset) == int(j.offset) == 42
    _buffers_equal(j, t, fields)
    _check_outputs(outs, decode_tol)


def test_rotated_int4_cache_matches_reference():
    """The rotated int4 cache (MLX_VLM_TPU_KV_SCHEME=turboquant, 4 bits):
    the int4 case at D = 128 after a rotation; the rotated codes are
    written identically."""
    D = 128
    j = jtq.make_rotated_int4_cache(1, 1, 2, D, C)
    t = ttq.make_rotated_int4_cache(1, 1, 2, D, C)
    assert isinstance(t, tcache.Int4KVCache)
    outs, j, t = cache_steps(j, t, D, seed=7, left_pad=0)
    _buffers_equal(j, t, ("k4", "ks", "kb", "v4", "vs", "vb"))
    _check_outputs(outs, ROUNDED)


# ------------------------------------------------------------ make_cache


class _Model:
    """The attributes make_cache reads, for both packages."""

    def __init__(self, lm):
        self.language_model = lm


def _lms(head_dim=128):
    from mlx_vlm_tpu.models.qwen2_vl.config import ModelConfig as JCfg
    from mlx_vlm_tpu.models.qwen2_vl.language import LanguageModel as JLM
    from mlx_vlm_tpu_torch.models.qwen2_vl import ModelConfig
    from mlx_vlm_tpu_torch.models.qwen2_vl.language import LanguageModel
    from mlx_vlm_tpu_torch.utils.testing import tiny_qwen2_vl_config

    cfg = tiny_qwen2_vl_config()
    cfg["num_attention_heads"] = 4
    cfg["num_key_value_heads"] = 2
    cfg["hidden_size"] = 4 * head_dim
    jc, tc = JCfg.from_dict(cfg), ModelConfig.from_dict(cfg)
    return _Model(JLM(jc.text_config, jc)), _Model(LanguageModel(
        tc.text_config, tc))


ROUTES = [  # (kv_bits, MLX_VLM_TPU_KV_SCHEME, MLX_VLM_TPU_TQ_SCHEME, head dim)
    (None, None, None, 128), (8, None, None, 128), (8, "int4", None, 128),
    (4, None, None, 128), (4, "turboquant", None, 128),
    (4, "turboquant", None, 96), (3.5, None, None, 128),
    (3.5, None, "split", 128), (3.5, "turboquant", "split", 96),
    (2.5, None, None, 128), (3, "turboquant", None, 128),
    (8, "turboquant", None, 128), (4, None, None, 96),
]


@pytest.mark.parametrize("kv_bits,kv_scheme,tq_scheme,hd", ROUTES)
def test_make_cache_follows_reference(monkeypatch, kv_bits, kv_scheme,
                                      tq_scheme, hd):
    from mlx_vlm_tpu.generate.ar import make_cache as jax_make
    from mlx_vlm_tpu_torch.generate.ar import make_cache

    for name, val in (("MLX_VLM_TPU_KV_SCHEME", kv_scheme),
                      ("MLX_VLM_TPU_TQ_SCHEME", tq_scheme)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    jm, tm = _lms(hd)
    ref = jax_make(jm, 1, 256, jnp.float32, kv_bits)
    got = make_cache(tm, 1, 256, torch.float32, kv_bits)
    # the reference's rotated cache class is `_RotatedInt4` under an alias
    want = {"_RotatedInt4": "RotatedInt4KVCache"}.get(type(ref).__name__,
                                                      type(ref).__name__)
    assert type(got).__name__ == want
    names = [f.name for f in __import__("dataclasses").fields(got)]
    for f in names:
        a, b = getattr(got, f), getattr(ref, f)
        if isinstance(a, torch.Tensor):
            assert tuple(a.shape) == tuple(b.shape), f
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), f
        elif f != "offset":
            assert a == b, f
    assert int(got.offset) == int(ref.offset) == 0


@pytest.mark.parametrize("kv_bits,kv_scheme", [(4, "affine"), (8, "affine"),
                                               (6, None), (2, None)])
def test_make_cache_group_affine_raises(monkeypatch, kv_bits, kv_scheme):
    """Where the reference picks its group-affine QuantizedKVCache, the port
    builds the same cache (buffers of the same shapes and dtypes, the same
    bits and group size); at a bit width `quantize` does not take (6) the
    port raises the reference's ValueError when the cache is built, where
    the reference raises it at the cache's first write."""
    from mlx_vlm_tpu.generate.ar import make_cache as jax_make
    from mlx_vlm_tpu_torch.generate.ar import make_cache

    if kv_scheme is None:
        monkeypatch.delenv("MLX_VLM_TPU_KV_SCHEME", raising=False)
    else:
        monkeypatch.setenv("MLX_VLM_TPU_KV_SCHEME", kv_scheme)
    jm, tm = _lms()
    ref = jax_make(jm, 1, 256, jnp.float32, kv_bits)
    assert type(ref).__name__ == "QuantizedKVCache"
    if kv_bits == 6:
        with pytest.raises(ValueError, match="Only 1/2/4/8-bit"):
            make_cache(tm, 1, 256, torch.float32, kv_bits)
        return
    got = make_cache(tm, 1, 256, torch.float32, kv_bits)
    assert type(got).__name__ == "QuantizedKVCache"
    assert (got.bits, got.group_size) == (ref.bits, ref.group_size)
    fields = ("kq", "ks", "kb", "vq", "vs", "vb")
    for f, b in zip(fields, ref.scan_arrays()):
        a = getattr(got, f)
        assert tuple(a.shape) == tuple(b.shape), f
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), f
    assert int(got.offset) == int(ref.offset) == 0


# ------------------------------------------------------------ the slice

SLICE_CASES = [(8, None), (4, None), (3.5, None), (3.5, "split")]


@pytest.fixture(scope="module")
def slice_models():
    """(jax model, port model, config): tiny Qwen2-VL with head dim 128
    (hidden 512, 4 heads over 2 KV heads, 2 layers) on w4grp weights, f32;
    the port gets the same parameters through params_from_jax."""
    from mlx_vlm_tpu.core.quant import quantize, to_int4_grouped
    from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
    from mlx_vlm_tpu.utils.testing import qwen2_vl_hf_weights
    from mlx_vlm_tpu_torch.models.qwen2_vl import Model, ModelConfig
    from mlx_vlm_tpu_torch.utils.loader import params_from_jax
    from mlx_vlm_tpu_torch.utils.testing import tiny_qwen2_vl_config

    cfg = tiny_qwen2_vl_config()
    cfg.update(hidden_size=512, intermediate_size=256, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2,
               rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]})
    cfg["vision_config"]["hidden_size"] = 32
    weights = qwen2_vl_hf_weights(cfg, seed=0)
    rng = np.random.default_rng(1)
    for k in list(weights):
        if (k.startswith("model.layers.") and k.endswith(".weight")
                and "layernorm" not in k and weights[k].ndim == 2):
            w = rng.standard_normal(weights[k].shape).astype(np.float32) * 0.1
            weights[k] = to_int4_grouped(
                quantize(jnp.asarray(w), bits=4, group_size=64))
    mp = pytest.MonkeyPatch()
    mp.setenv("MLX_VLM_TPU_FUSED_DECODE", "0")
    try:
        jm = jax_load(dict(cfg), dict(weights), jnp.float32)
    finally:
        mp.undo()
    tm = Model(ModelConfig.from_dict(cfg))
    tm.params = params_from_jax(tm, jax.tree_util.tree_map(np.asarray,
                                                           jm.params))
    tm.config_dict = cfg
    tm.device = torch.device("cpu")
    assert tm.language_model.head_dim == 128
    return jm, tm, cfg


PROMPT = [int(t) for t in np.random.default_rng(6).integers(0, 256, 37)]
N_STEPS = 8


def _set_scheme(monkeypatch, tq_scheme):
    if tq_scheme is None:
        monkeypatch.delenv("MLX_VLM_TPU_TQ_SCHEME", raising=False)
    else:
        monkeypatch.setenv("MLX_VLM_TPU_TQ_SCHEME", tq_scheme)
    monkeypatch.delenv("MLX_VLM_TPU_KV_SCHEME", raising=False)


def _jax_greedy_logits(jm, kv_bits):
    """The reference's logits along its own greedy path: the prompt in one
    chunk, then N_STEPS - 1 decode steps on its quantized cache."""
    from mlx_vlm_tpu.generate.ar import make_cache as jax_make

    ids = jnp.asarray([PROMPT])
    lm, lp = jm.language_model, jm.params["language_model"]
    cache = jax_make(jm, 1, 256, jnp.float32, kv_bits)
    pos = jnp.broadcast_to(jnp.arange(len(PROMPT))[None, None],
                           (3, 1, len(PROMPT)))
    logits, cache = jm(jm.params, lm.embed(lp, ids), cache, pos)
    out, toks = [np.asarray(logits[0, -1])], []
    for _ in range(N_STEPS - 1):
        toks.append(int(np.argmax(out[-1])))
        p = jnp.full((3, 1, 1), int(cache.offset), jnp.int32)
        logits, cache = jm(jm.params, lm.embed(lp, jnp.asarray([[toks[-1]]])),
                           cache, p)
        out.append(np.asarray(logits[0, 0]))
    return np.stack(out), toks, type(cache).__name__


def _port_forced_logits(tm, kv_bits, toks):
    from mlx_vlm_tpu_torch.generate.ar import make_cache

    lm, lp = tm.language_model, tm.params["language_model"]
    cache = make_cache(tm, 1, 256, torch.float32, kv_bits)
    pos = torch.arange(len(PROMPT)).expand(3, 1, len(PROMPT))
    logits = tm(tm.params, lm.embed(lp, torch.tensor([PROMPT])), cache, pos)
    out = [logits[0, -1].numpy()]
    for tok in toks:
        p = torch.full((3, 1, 1), int(cache.offset))
        out.append(tm(tm.params, lm.embed(lp, torch.tensor([[tok]])), cache,
                      p)[0, 0].numpy())
    return np.stack(out), type(cache).__name__


def bench_rule(ref):
    """bench.py's logit bound and the steps whose margin engages argmax."""
    tol = 0.05 * max(1.0, float(np.abs(ref).max()))
    top2 = np.sort(ref, axis=-1)[:, -2:]
    return tol, (top2[:, 1] - top2[:, 0]) > 2 * tol


@pytest.mark.parametrize("kv_bits,tq_scheme", SLICE_CASES)
def test_slice_matches_reference(slice_models, monkeypatch, kv_bits,
                                 tq_scheme):
    """Teacher-forced logits meet bench.py's parity rule, and the port's
    greedy stream_generate ids equal the reference's greedy path at every
    step until the first whose top-1/top-2 margin is within twice the
    rule's bound (after a tie may break either way the contexts differ)."""
    from mlx_vlm_tpu_torch.generate.dispatch import stream_generate
    from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

    jm, tm, _ = slice_models
    _set_scheme(monkeypatch, tq_scheme)
    ref, toks, jname = _jax_greedy_logits(jm, kv_bits)
    got, tname = _port_forced_logits(tm, kv_bits, toks)
    assert tname == jname
    tol, margin_ok = bench_rule(ref)
    assert np.abs(got - ref).max() <= tol
    assert np.all((got.argmax(-1) == ref.argmax(-1))[margin_ok])

    ids = [r.token for r in stream_generate(
        tm, ByteTokenizer(), PROMPT, max_tokens=N_STEPS,
        prefill_step_size=64, kv_bits=kv_bits)]
    ref_ids = [int(t) for t in ref.argmax(-1)]  # toks, then the last step's
    assert len(ids) == N_STEPS
    for i, (a, b) in enumerate(zip(ids, ref_ids)):
        if a != b:
            assert not margin_ok[i], (i, ids, ref_ids)
            break


# ------------------------------------------------------------ K6's kernel

KERNEL_SOURCE = (Path(k6.__file__).resolve().parent.parent / "csrc"
                 / "int4_kv_attention.cu")
HEADER_SOURCE = KERNEL_SOURCE.parent / "kv_decode_common.cuh"


def key_slot_dim(D, st, slot):
    """Head dim of slot `slot` (0..31) of key k-step `st`, or -1 for a pad
    slot (csrc/int4_kv_attention.cu's key slot order): slots 4 tig + e
    take the low nibbles of code word 4 st + tig (dims 16 st + 4 tig + e),
    slots 16 + 4 tig + e its high nibbles (dims D/2 + 16 st + 4 tig + e)."""
    h = D // 2
    byte = st * k6.KEY_BYTES + (slot & 15)
    if byte >= h:
        return -1
    return byte + (h if slot >= 16 else 0)


def value_slot_dims(D, mt, gid):
    """(dim of m-slot gid, dim of m-slot gid + 8) of value m-tile mt, -1
    past D/2: the low and high nibble of code byte 32 (mt // 4) + 4 gid +
    mt % 4."""
    h = D // 2
    b = k6.GROUP_BYTES * (mt // 4) + 4 * gid + mt % 4
    return (b, h + b) if b < h else (-1, -1)


def prmt(a, b, sel):
    """PTX prmt.b32 (default mode) on uint32 numpy arrays."""
    pool = [(a >> (8 * i)) & 0xFF for i in range(4)]
    pool += [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= pool[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def bf16_pair_values(x):
    """uint32 words as two bf16 values each (low half first) -> f32."""
    lo = (x & 0xFFFF).astype(np.uint32) << 16
    hi = (x >> 16).astype(np.uint32) << 16
    return lo.view(np.float32), hi.view(np.float32)


@pytest.mark.parametrize("D", [128, 256, 80, 8])
def test_k6_key_slots_emulation_is_exact(D):
    """int32 emulation of the kernel's key dot: each token's packed code
    words cut by the two LOP3 masks (x & 0x0F0F0F0F, (x >> 4) &
    0x0F0F0F0F) against the query codes laid out in the same slot order,
    zero in pad slots, over every k-step.  The bytes past D/2 in a padded
    k-step are the next row's (random here), and must cancel.  It must
    equal q8 . k exactly."""
    rng = np.random.default_rng(D)
    h, n, g = D // 2, 37, 7
    steps = k6.key_steps(D)
    q8 = rng.integers(-127, 128, (g, D)).astype(np.int32)
    codes = rng.integers(0, 16, (n, D)).astype(np.int32)
    packed = (codes[:, :h] | (codes[:, h:] << 4)).astype(np.uint8)
    # each row as the kernel reads it: whole k-steps, bytes past h from
    # whatever follows
    rows = np.concatenate([packed, rng.integers(
        0, 256, (n, steps * k6.KEY_BYTES - h), dtype=np.uint8)], axis=1)
    words = rows.view("<u4").astype(np.int64)               # [n, 4 steps]
    qf = np.zeros((g, steps, 32), np.int64)
    for st in range(steps):
        for slot in range(32):
            dim = key_slot_dim(D, st, slot)
            if dim >= 0:
                qf[:, st, slot] = q8[:, dim]
    got = np.zeros((g, n), np.int64)
    for st in range(steps):
        for tig in range(4):
            x = words[:, 4 * st + tig]
            for e in range(4):
                lo = ((x & 0x0F0F0F0F) >> (8 * e)) & 0xFF
                hi = (((x >> 4) & 0x0F0F0F0F) >> (8 * e)) & 0xFF
                got += qf[:, st, 4 * tig + e, None] * lo[None]
                got += qf[:, st, 16 + 4 * tig + e, None] * hi[None]
    np.testing.assert_array_equal(got, q8.astype(np.int64) @ codes.T)
    # every dim in exactly one slot
    dims = [key_slot_dim(D, st, sl) for st in range(steps)
            for sl in range(32)]
    assert sorted(d for d in dims if d >= 0) == list(range(D))


@pytest.mark.parametrize("D", [128, 256, 80])
def test_k6_value_operands_emulation(D):
    """The value m-tiles cover each dim once, and the kernel's operand
    build -- prmt of byte k of two tokens' words, then (t & 0x000F000F) |
    0x43004300 (after t >> 4 for the high nibbles) as bf16 minus 128 --
    gives each m-slot's code exactly."""
    h = D // 2
    groups = -(-h // k6.GROUP_BYTES)
    dims = [d for mt in range(4 * groups) for gid in range(8)
            for d in value_slot_dims(D, mt, gid) if d >= 0]
    assert sorted(dims) == list(range(D))
    rng = np.random.default_rng(D + 1)
    w0, w1 = (rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    for k in range(4):
        t = prmt(w0, w1, 0x4400 + 0x1111 * k)
        for shift, nib in ((0, lambda x: x & 15), (4, lambda x: x >> 4)):
            x = ((t >> shift) & 0x000F000F) | 0x43004300
            lo, hi = bf16_pair_values(x.astype(np.uint32))
            byte0, byte1 = (w0 >> (8 * k)) & 0xFF, (w1 >> (8 * k)) & 0xFF
            # bf16(128 + q) - 128 is exact
            np.testing.assert_array_equal(lo - 128, nib(byte0))
            np.testing.assert_array_equal(hi - 128, nib(byte1))


def test_k6_plan_at_request_f():
    """(f) kv_bits 4 on Qwen2-VL-7B's 4 KV heads of 7 query rows over an
    8704-slot cache at D = 128: 32 splits of 272 tokens (one block per SM
    of 132, 128 blocks), 9 warps for 17 tiles, 8 combiners."""
    p = k6.int4_kv_attention_plan(4, 7, 8704, 128)
    assert p == k6.SplitPlan(tokens=272, splits=32, combiners=8, warps=9,
                             n_tiles=1, row_groups=1, smem_bytes=95776)
    # 2B's 2 KV heads of 6 rows
    two_b = k6.int4_kv_attention_plan(2, 6, 8704, 128)
    assert (two_b.tokens, two_b.splits, two_b.warps) == (144, 61, 9)


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("C", [250, 8704, 32768])
@pytest.mark.parametrize("G", [1, 7, 8, 9, 16, 17])
@pytest.mark.parametrize("BH", [1, 4])
def test_k6_plan_covers_and_fits(D, C, G, BH):
    """The splits cover [0, C) in whole tiles, a block's shared memory
    fits, at most min(8, SMs / (heads * row groups)) combiners, and G
    rows take one n-tile up to 8, two up to 16, then groups of 16."""
    p = k6.int4_kv_attention_plan(BH, G, C, D)
    assert p.tokens % k6.TILE == 0 and p.tokens <= k6.MAX_TOKENS
    assert p.splits * p.tokens >= C > (p.splits - 1) * p.tokens
    assert p.smem_bytes == k6._smem_bytes(p.tokens, D, p.n_tiles, p.warps)
    assert p.smem_bytes <= k6.SMEM_BYTES
    assert 1 <= p.combiners <= min(k6.MAX_COMBINERS, p.splits,
                                   max(1, 132 // (BH * p.row_groups)))
    assert p.n_tiles == (1 if G <= 8 else 2)
    assert p.row_groups == -(-G // (8 * p.n_tiles))
    assert 1 <= p.warps <= (k6.MAX_WARPS if p.n_tiles == 1 else 8)
    assert p.warps * -(-(p.tokens // 16) // p.warps) >= p.tokens // 16


def test_k6_plan_refuses():
    """D must be a multiple of 8 (whole code words a token); no rows, no
    capacity."""
    for args in ((4, 7, 8704, 12), (4, 7, 8704, 130), (4, 0, 8704, 128),
                 (4, 7, 0, 128)):
        with pytest.raises(ValueError):
            k6.int4_kv_attention_plan(*args)


def test_k6_plan_mirrors_kernel_constants_and_layout():
    """The Python constants equal csrc/int4_kv_attention.cu's, and
    `kv4_layout` lays out the regions `_smem_bytes` counts, in its order;
    the two-pass design and its combine kernel are gone, and the split's
    end (arrival and combine) is kv_decode_common.cuh's, shared with
    K7 / K8."""
    src = KERNEL_SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    for name in ("TILE", "MAX_NT", "MAX_WARPS", "ARRAY_SLACK",
                 "MAX_COMBINERS", "KEY_BYTES", "GROUP_BYTES"):
        assert int(consts[name]) == getattr(k6, name), name
    layout = src[src.index("inline Kv4Layout kv4_layout("):]
    layout = layout[:layout.index("L.bytes = o;")]
    assert re.findall(r"L\.(\w+)(?:\[j\])? = o;", layout) == [
        "qraw", "meta", "qf", "S", "pv", "ml", "bias", "part", "red", "arr"]
    assert "kv4_layout(T, D, nt, warps).bytes != smem" in src
    assert "finish_split(" in src
    header = HEADER_SOURCE.read_text()
    for gone in ("int4_kv_split_kernel", "combine_kernel", "block_softmax",
                 "live_range"):
        assert gone not in src and gone not in header, gone
    tq_src = (KERNEL_SOURCE.parent / "tq_kv_attention.cu").read_text()
    assert "finish_split(" in tq_src
    assert "void combine_splits(" in header
    assert "combine_splits(" not in src and "void combine_splits(" \
        not in tq_src


def test_int4_route_takes_whole_word_rows(monkeypatch):
    """A decode step runs K6 when D is a multiple of 8; another D takes the
    integer-domain attend, which agrees with the reference's attend (its
    XLA route) in f32 -- and K6 is never called for it."""
    assert tcache.int4_kv_route(1, 128) and tcache.int4_kv_route(1, 256)
    assert tcache.int4_kv_route(1, 80)
    assert not tcache.int4_kv_route(1, 12)
    assert not tcache.int4_kv_route(1, 130)
    assert not tcache.int4_kv_route(2, 128)

    def refuse(*args, **kwargs):
        raise AssertionError("K6 called at D = 12")

    monkeypatch.setattr(k6, "int4_kv_decode_attention", refuse)
    D, nkv = 12, 2
    j = jcache.init_int4_cache(1, 1, nkv, D, C,
                               left_pad=jnp.asarray([3], jnp.int32))
    t = tcache.init_int4_cache(1, 1, nkv, D, C, left_pad=torch.tensor([3]))
    outs, j, t = cache_steps(j, t, D, seed=12)
    _check_outputs(outs, PREFILL)


def test_loader_defaults_to_the_card():
    """Without `device`, the loaders load onto the GPU: on a host without
    one they raise before reading anything."""
    from mlx_vlm_tpu_torch import load, load_model
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.testing import tiny_qwen2_vl_config

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    for call in (lambda: load_model_from_weights(tiny_qwen2_vl_config(), {}),
                 lambda: load_model("/nonexistent"),
                 lambda: load("/nonexistent")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cpu_calls_leave_k6_counter_at_zero():
    before = dict(k6.launches)
    q8, meta, k4, ks, kb, v4, vs, vb = k6_inputs(128, seed=3)
    k6.int4_kv_decode_attention(
        *(torch.from_numpy(a) for a in (q8, meta, k4, ks, kb, v4, vs, vb)),
        10, 0.1)
    assert k6.launches == before == {"int4_kv_attention": 0}


# ----------------------------------------------------------- on a GPU only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_cuda_k6_matches_plain(cuda_device, D, rows):
    """The kernel against its plain version on the card, q sharpened by 4;
    tolerance 1e-2 * max|ref|: the kernel rounds p * vs to bf16 against a
    block-local maximum instead of the global one."""
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in k6_inputs(D, seed=D + 1, q_scale=4.0)]
    if rows == "scalar":
        off, lp = 150, torch.full((BH,), 20, dtype=torch.int32)
    else:
        off, lp = torch.from_numpy(ROW_OFFSETS), torch.from_numpy(ROW_LEFT_PAD)
    if isinstance(off, torch.Tensor):
        off = off.to(cuda_device)
    lp = lp.to(cuda_device)
    n0 = k6.launches["int4_kv_attention"]
    got = k6.int4_kv_decode_attention(*arrs, off, D ** -0.5, left_pad=lp)
    ref = k6.int4_kv_decode_attention_plain(
        *arrs, k6._rows(off, BH, cuda_device), D ** -0.5, lp)
    torch.cuda.synchronize()
    assert k6.launches["int4_kv_attention"] == n0 + 1
    assert float((got - ref).abs().max()) <= 1e-2 * float(ref.abs().max())


def k6_card_inputs(device, D=128, g=G, c=C, seed=0, q_scale=4.0):
    """K6 inputs of BH heads x g rows x c slots (k6_inputs' recipe) on the
    card."""
    rng = np.random.default_rng(seed)
    qf = rng.standard_normal((BH, g, D)).astype(np.float32) * q_scale
    qs = np.abs(qf).max(-1) / 127.0
    q8 = np.round(qf / qs[..., None]).astype(np.int8)
    meta = np.stack([q8.astype(np.int32).sum(-1).astype(np.float32), qs],
                    -1).astype(np.float32)
    k4, v4 = (rng.integers(0, 256, (BH, c, D // 2), dtype=np.uint8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.05, 0.3, (BH, c)).astype(np.float32)
              for _ in range(2))
    kb, vb = (rng.uniform(-2, 0, (BH, c)).astype(np.float32)
              for _ in range(2))
    return [torch.from_numpy(a).to(device)
            for a in (q8, meta, k4, ks, kb, v4, vs, vb)]


def _card_cursors(device, c=C):
    """Per-row cursors inside a capacity of c: row 1 sees [5, 37), row 2
    nothing."""
    off = torch.tensor([min(200, c), 37, 100], dtype=torch.int32)
    lp = torch.tensor([0, 5, 100], dtype=torch.int32)
    return off.to(device), lp.to(device)


def _k6_close(got, ref):
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-2 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("g", [1, 7, 8, 9, 16, 17])
def test_cuda_k6_rows_and_dims(cuda_device, D, g):
    """One n-tile (g <= 8), two (9..16) and row groups (17), at both head
    dims, against the plain version; tolerance as test_cuda_k6_matches_plain
    (bf16(p * vs) against split-local maxima)."""
    arrs = k6_card_inputs(cuda_device, D=D, g=g, seed=D + g)
    off, lp = _card_cursors(cuda_device)
    got = k6.int4_kv_decode_attention(*arrs, off, D ** -0.5, left_pad=lp)
    ref = k6.int4_kv_decode_attention_plain(*arrs, off, D ** -0.5, lp)
    torch.cuda.synchronize()
    assert got.shape == (BH, g, D)
    assert not got[2].any()  # row 2 sees nothing -> 0
    _k6_close(got, ref)


@pytest.mark.cuda
def test_cuda_k6_ragged_capacity(cuda_device):
    """C = 250, not a multiple of 16: the last tile is cut at the capacity,
    and the f32 scale runs of a head start unaligned (250 * 4 bytes)."""
    arrs = k6_card_inputs(cuda_device, c=250, seed=250)
    off = torch.tensor([250, 249, 17], dtype=torch.int32, device=cuda_device)
    lp = torch.tensor([0, 3, 0], dtype=torch.int32, device=cuda_device)
    got = k6.int4_kv_decode_attention(*arrs, off, 128 ** -0.5, left_pad=lp)
    ref = k6.int4_kv_decode_attention_plain(*arrs, off, 128 ** -0.5, lp)
    torch.cuda.synchronize()
    _k6_close(got, ref)


@pytest.mark.cuda
def test_cuda_k6_ignores_nan_past_the_cursor(cuda_device):
    """NaN scales and biases past each cursor do not reach the output: it
    is bit-identical to the output with finite values there (the kernel
    masks by select), and within tolerance of the plain version on those."""
    arrs = k6_card_inputs(cuda_device, seed=11)
    off, lp = _card_cursors(cuda_device)
    nan = [a.clone() for a in arrs]
    col = torch.arange(C, device=cuda_device)[None]
    for i in (3, 4, 6, 7):
        nan[i][col >= off[:, None]] = float("nan")
    got = k6.int4_kv_decode_attention(*nan, off, 128 ** -0.5, left_pad=lp)
    fin = k6.int4_kv_decode_attention(*arrs, off, 128 ** -0.5, left_pad=lp)
    ref = k6.int4_kv_decode_attention_plain(*arrs, off, 128 ** -0.5, lp)
    torch.cuda.synchronize()
    assert torch.equal(got, fin)
    _k6_close(got, ref)


@pytest.mark.cuda
def test_cuda_k6_one_kernel_repeat_and_counters(cuda_device):
    """One call puts one kernel on the device (CUDA graph nodes), a second
    call gives the same bits (the splits are combined in a fixed order),
    and the per-card counters it shares with K7 / K8 are back at zero."""
    from chip_smoke import kernels_per_call
    from mlx_vlm_tpu_torch.ops import tq_kv_attention as tk

    arrs = k6_card_inputs(cuda_device, c=8704, seed=5)
    off = torch.tensor([8545, 300, 1], dtype=torch.int32, device=cuda_device)
    lp = torch.tensor([0, 100, 0], dtype=torch.int32, device=cuda_device)

    def call():
        return k6.int4_kv_decode_attention(*arrs, off, 128 ** -0.5,
                                           left_pad=lp)

    outs = [call() for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert kernels_per_call(call) == 1
    assert k6._tickets is tk._tickets
    assert not k6._tickets(cuda_device, 1).any()
    _k6_close(outs[0], k6.int4_kv_decode_attention_plain(
        *arrs, off, 128 ** -0.5, lp))


@pytest.mark.cuda
def test_cuda_k6_refuses_before_launching(cuda_device):
    """On the card the wrapper launches or raises first: a head dim that is
    not a multiple of 8, or codes of the wrong dtype, launch nothing."""
    n0 = k6.launches["int4_kv_attention"]
    arrs = k6_card_inputs(cuda_device, D=12, seed=1)
    with pytest.raises(ValueError):
        k6.int4_kv_decode_attention(*arrs, 10, 0.1)
    arrs = k6_card_inputs(cuda_device, seed=1)
    arrs[2] = arrs[2].to(torch.int16)
    with pytest.raises(TypeError):
        k6.int4_kv_decode_attention(*arrs, 10, 0.1)
    assert k6.launches["int4_kv_attention"] == n0
