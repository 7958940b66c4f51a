"""Port parity: kernel modules and the layers around them.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
they are held to the JAX package's Pallas kernels in interpret mode at f32
(tolerance 1e-5 abs / 1e-4 rel).  Tests marked `cuda` compare each CUDA
kernel with its plain version on a GPU and skip without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlx_vlm_tpu.core import quant as jq
from mlx_vlm_tpu.core.mask import causal_cache_mask as jax_mask
from mlx_vlm_tpu.core.rope import make_rope as jax_make_rope
from mlx_vlm_tpu.ops.attention import sdpa as jax_sdpa
from mlx_vlm_tpu.ops.flash_attention import flash_attention as jax_flash
from mlx_vlm_tpu.ops.int4_matvec import int4_matvec as jax_int4_matvec
from mlx_vlm_tpu_torch.core import quant as tq
from mlx_vlm_tpu_torch.core.mask import causal_cache_mask
from mlx_vlm_tpu_torch.core.rope import apply_rope, make_rope
from mlx_vlm_tpu_torch.ops import _cuda
from mlx_vlm_tpu_torch.ops import flash_attention as fa
from mlx_vlm_tpu_torch.ops import int4_matvec as iv
from mlx_vlm_tpu_torch.ops.attention import sdpa

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4


def _jax_int4(n, k, seed, layers=None, g=64):
    """JAX Int4GroupedTensor (numpy fields) from random f32 weights, group
    size g; stacked over `layers` when given."""
    rng = np.random.default_rng(seed)

    def one():
        w = rng.standard_normal((n, k)).astype(np.float32) * 0.1
        return jq.to_int4_grouped(jq.quantize(jnp.asarray(w), 4, g))

    if layers is None:
        return one()
    ts = [one() for _ in range(layers)]
    return jq.Int4GroupedTensor(
        **{f: np.stack([np.asarray(getattr(t, f)) for t in ts])
           for f in ("qp", "sl", "sh", "bl", "bh")},
        n=n, group_size=g, out_dtype="float32")


def _port_int4(t):
    return tq.Int4GroupedTensor(
        **{f: torch.from_numpy(np.asarray(getattr(t, f)))
           for f in ("qp", "sl", "sh", "bl", "bh")},
        n=t.n, group_size=t.group_size, out_dtype="float32")


@pytest.mark.parametrize("M", [1, 2, 5, 8, 64, 300])
@pytest.mark.parametrize("stacked", [False, True])
def test_int4_matvec_matches_pallas(M, stacked):
    K, N = 128, 200
    t = _jax_int4(N, K, seed=M, layers=3 if stacked else None)
    x = np.random.default_rng(M + 1).standard_normal((M, K)).astype(np.float32)
    layer = 2 if stacked else None
    ref = np.asarray(jax_int4_matvec(jnp.asarray(x), jq.Int4GroupedTensor(
        **{f: jnp.asarray(getattr(t, f)) for f in ("qp", "sl", "sh", "bl", "bh")},
        n=t.n, group_size=64, out_dtype="float32"), layer))
    got = iv.int4_matvec(torch.from_numpy(x), _port_int4(t), layer).numpy()
    assert got.shape == (M, N)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_int4_matvec_leading_dims_and_bf16_rounding():
    t = _port_int4(_jax_int4(64, 128, seed=7))
    x = torch.randn((2, 3, 128), generator=torch.Generator().manual_seed(0))
    y = iv.int4_matvec(x, t)
    assert y.shape == (2, 3, 64) and y.dtype == torch.float32
    # K1's plain version rounds the dequantized weight to x.dtype
    xb = x.reshape(6, 128).to(torch.bfloat16)
    w = tq.int4_grouped_dequantize(t, torch.bfloat16).T.float()
    ref = (xb.float() @ w).to(torch.bfloat16)
    assert torch.equal(iv.int4_matmul_plain(xb, t), ref)
    # K2's plain version keeps the f32 dequant and returns f32
    assert iv.int4_matvec_plain(xb[:2], t).dtype == torch.float32


def _visible_rows(offset, left_pad, S, C, window):
    """[B, S] True where query row i keeps at least one cache column."""
    pos = offset[:, None] + np.arange(S)[None]
    lo = np.maximum(left_pad[:, None], 0)
    if window is not None:
        lo = np.maximum(lo, pos - window + 1)
    hi = np.minimum(pos, C - 1)
    return hi >= lo


# (window, S, C, offsets, left_pads, seed): the first two are the original
# small cases; then S = 136, not a multiple of K4's 128-row query tile, and
# a left_pad (133) and a window edge that fall inside 128-column KV tiles
@pytest.mark.parametrize("window,S,C,offset,left_pad,seed", [
    pytest.param(None, 16, 64, (40, 3), (0, 5), 0, id="None"),
    pytest.param(6, 16, 64, (40, 3), (0, 5), 1, id="6"),
    pytest.param(None, 136, 256, (100, 3), (0, 5), 2, id="S136"),
    pytest.param(50, 136, 512, (300, 100), (37, 133), 3,
                 id="edges_inside_tiles"),
])
def test_flash_attention_matches_pallas(window, S, C, offset, left_pad, seed):
    B, H, KVH, D = 2, 4, 2, 16
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, C, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, C, D)).astype(np.float32)
    offset = np.array(offset, np.int32)
    left_pad = np.array(left_pad, np.int32)  # row 1: early queries see nothing
    scale = D**-0.5
    ref = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offset),
        jnp.asarray(left_pad), scale, q_tile=16, window=window,
        interpret=True))
    got = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(offset), torch.from_numpy(left_pad), scale,
        window).numpy()
    vis = _visible_rows(offset, left_pad, S, C, window)
    assert not vis.all()  # the case covers padding rows; they are skipped
    sel = np.broadcast_to(vis[:, None, :], (B, H, S))
    np.testing.assert_allclose(got[sel], ref[sel], atol=ATOL, rtol=RTOL)


# request (c) of chip_smoke.py: its ~8.6k-token prompt is prefilled in 17
# chunks of 512 rows (offsets 0, 512, ..., 8192) against an 8704-slot cache
@pytest.mark.parametrize("offset", range(0, 8704, 512))
def test_flash_attention_plan_at_request_c_chunks(offset):
    """Every chunk of (c) fits the cache and is planned as one launch of
    4 x 28 blocks of 128 query rows over 128-column tiles, KV unsplit."""
    S, C = 512, 8704
    assert offset + S <= C
    assert fa.flash_attention_plan(1, 28, 4, S, C, fa.HEAD_DIM) == (
        (4, 28, 1), 128, 128, 1)


@pytest.mark.parametrize("B,S,grid", [(1, 1, (1, 28, 1)), (1, 128, (1, 28, 1)),
                                      (1, 129, (2, 28, 1)), (2, 300, (3, 28, 2))])
def test_flash_attention_plan_ragged(B, S, grid):
    assert fa.flash_attention_plan(B, 28, 4, S, 8192, 128) == (grid, 128, 128, 1)


@pytest.mark.parametrize("B,H,KVH,S,C,D", [
    (1, 28, 4, 512, 8192, 64),    # head size
    (1, 28, 3, 512, 8192, 128),   # H % KVH
    (1, 28, 4, 512, 8200, 128),   # C % 64
    (1, 28, 4, 0, 8192, 128),     # no query rows
    (0, 28, 4, 512, 8192, 128),   # no batch rows
])
def test_flash_attention_refuses_before_launch(B, H, KVH, S, C, D):
    """The plan raises for what K4 does not take, and so does the wrapper
    before any launch (meta tensors stand in for CUDA ones)."""
    with pytest.raises(ValueError):
        fa.flash_attention_plan(B, H, KVH, S, C, D)
    before = dict(fa.launches)
    q = torch.empty((B, H, S, D), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((B, KVH, C, D), dtype=torch.bfloat16, device="meta")
    pos = torch.zeros((B,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv, pos, pos, D**-0.5)
    # a shape it takes gets past the plan (meta is not CUDA)
    q = torch.empty((1, 28, 512, 128), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 4, 8192, 128), dtype=torch.bfloat16, device="meta")
    pos = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="CUDA tensors"):
        fa.flash_attention(q, kv, kv, pos, pos, 128**-0.5)
    assert fa.launches == before


@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_flash_route_takes_k4_head_size(D):
    """K4 takes head size 128 only (`flash_attention_plan` refuses others):
    the route rule decides it by shape, before any launch, so a prefill
    chunk of head size 64, 80 or 256 that passes the reference's rule (S
    >= 256, C >= 8192 and a multiple of 128) takes `sdpa`, and the cache's
    attend there matches K4's plain version (1e-5 abs / 1e-4 rel, f32).
    CUDA is claimed by stand-ins, as the rule reads devices and shapes
    only."""
    from types import SimpleNamespace

    from mlx_vlm_tpu_torch.core import cache as tcache

    B, H, KVH, S, C = 1, 4, 2, 256, 8192

    def on_cuda(shape):
        return SimpleNamespace(device=SimpleNamespace(type="cuda"),
                               shape=shape)

    routed = tcache.flash_eligible(on_cuda((B, H, S, D)),
                                   on_cuda((B, KVH, C, D)))
    assert routed == (D == fa.HEAD_DIM)
    if D != fa.HEAD_DIM:
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_plan(B, H, KVH, S, C, D)
    rng = np.random.default_rng(D)
    cache = tcache.init_cache(1, B, KVH, D, C, torch.float32)
    cache.offset.fill_(300)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, S, D)).astype(
        np.float32)) for n in (H, KVH, KVH))
    mask = causal_cache_mask(cache.offset, cache.left_pad, S, C)
    before = dict(fa.launches)
    got = cache.attend(0, q, k, v, D**-0.5, mask)
    ref = fa.flash_attention_plain(q, cache.k[0], cache.v[0],
                                   cache.offset.expand(B), cache.left_pad,
                                   D**-0.5)
    assert fa.launches == before
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_sdpa_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 12, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 12, 8)).astype(np.float32)
    off, lp = np.array([7, 7], np.int32), np.array([0, 3], np.int32)
    mj = jax_mask(jnp.asarray(7), jnp.asarray(lp), 5, 12)
    mt = causal_cache_mask(7, torch.from_numpy(lp), 5, 12)
    assert np.array_equal(np.asarray(mj), mt.numpy())
    ref = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              0.35, mj))
    got = sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               0.35, mt).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    # per-row cursors build the same mask
    mt2 = causal_cache_mask(torch.from_numpy(off), torch.from_numpy(lp), 5, 12)
    assert torch.equal(mt, mt2)


def test_mrope_cos_sin_and_apply_match():
    scaling = {"type": "mrope", "mrope_section": [2, 3, 3]}
    jr = jax_make_rope(16, 10000.0, scaling)
    tr = make_rope(16, 10000.0, scaling)
    pos = np.random.default_rng(3).integers(0, 50, (3, 2, 6)).astype(np.int32)
    jc, js = jr.cos_sin(jnp.asarray(pos))
    tc, ts = tr.cos_sin(torch.from_numpy(pos.astype(np.int64)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    from mlx_vlm_tpu.core.rope import apply_rope as jax_apply

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 3, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 1, 6, 16)).astype(np.float32)
    jq_, jk_ = jax_apply(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq_, tk_ = apply_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    np.testing.assert_allclose(tq_.numpy(), np.asarray(jq_), atol=ATOL)
    np.testing.assert_allclose(tk_.numpy(), np.asarray(jk_), atol=ATOL)


# the scaled RoPE variants of core/rope.py's Rope, each as a published
# config writes its rope_scaling (Llama-3.1, a YaRN Qwen, a linear one,
# Phi-3's longrope with and without long_mscale, Gemma-4's proportional)
ROPE_SCALINGS = {
    "llama3": {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
               "original_max_position_embeddings": 8192,
               "rope_type": "llama3"},
    "yarn": {"type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 32768, "mscale": 0.707,
             "mscale_all_dim": 0.0},
    "linear": {"type": "linear", "factor": 2.5},
    "longrope": {"type": "longrope", "original_max_position_embeddings": 4096,
                 "long_factor": list(np.linspace(1.0, 8.0, 32)),
                 "short_factor": [1.0] * 32},
    "su": {"type": "su", "original_max_position_embeddings": 4096,
           "long_factor": list(np.linspace(1.0, 3.0, 32)),
           "long_mscale": 1.19},
    "proportional": {"rope_type": "proportional", "factor": 8.0,
                     "partial_rotary_factor": 0.25},
}


@pytest.mark.parametrize("kind", sorted(ROPE_SCALINGS))
def test_scaled_rope_tables_match(kind):
    """The inverse frequencies and attention scaling of each scaled variant
    equal the reference's; cos / sin at positions up to 100k within 1e-6
    (plain and M-RoPE-shaped ids); partial rotary (the rotated sub-dim at
    half the head) applies as the reference's."""
    from mlx_vlm_tpu.core.rope import apply_rope as jax_apply

    jr = jax_make_rope(64, 500000.0, ROPE_SCALINGS[kind], 131072)
    tr = make_rope(64, 500000.0, ROPE_SCALINGS[kind], 131072)
    assert np.array_equal(tr.inv_freq, jr.inv_freq)
    assert tr.attention_scaling == jr.attention_scaling
    if kind in ("yarn", "longrope", "su"):
        assert tr.attention_scaling != 1.0
    pos = np.random.default_rng(7).integers(0, 100000, (2, 9)).astype(
        np.int32)
    for p in (pos, np.broadcast_to(pos[None], (3, 2, 9))):
        jc, js = jr.cos_sin(jnp.asarray(p))
        tc, ts = tr.cos_sin(torch.from_numpy(p.astype(np.int64)))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 4, 9, 128)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 128)).astype(np.float32)
    jq, jk = jax_apply(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = apply_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    assert torch.equal(tq[..., 64:], torch.from_numpy(q[..., 64:]))


@pytest.mark.parametrize("name", ["rms_norm", "layer_norm", "swiglu_mlp"])
def test_layers_match(name):
    from mlx_vlm_tpu.core import layers as jl
    from mlx_vlm_tpu_torch.core import layers as tl

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    if name == "swiglu_mlp":
        p = {n: {"weight": rng.standard_normal(s).astype(np.float32) * 0.2}
             for n, s in (("gate_proj", (48, 32)), ("up_proj", (48, 32)),
                          ("down_proj", (32, 48)))}
    else:
        p = {"weight": rng.standard_normal(32).astype(np.float32),
             "bias": rng.standard_normal(32).astype(np.float32)}

    def conv(tree, fn):
        return {k: conv(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}

    ref = np.asarray(getattr(jl, name)(conv(p, jnp.asarray), jnp.asarray(x)))
    got = getattr(tl, name)(conv(p, torch.from_numpy), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_sampling_matches_reference():
    from mlx_vlm_tpu.core import sampling as js
    from mlx_vlm_tpu_torch.core import sampling as ts

    logits = np.random.default_rng(6).standard_normal((3, 50)).astype(np.float32)
    lj, lt = jnp.asarray(logits), torch.from_numpy(logits)
    assert np.array_equal(np.asarray(js.make_sampler()(lj, None)),
                          ts.make_sampler()(lt).numpy())
    np.testing.assert_array_equal(np.asarray(js._apply_top_k(lj, 5)),
                                  ts._apply_top_k(lt, 5).numpy())
    np.testing.assert_array_equal(np.asarray(js._apply_top_p(lj, 0.7)),
                                  ts._apply_top_p(lt, 0.7).numpy())
    np.testing.assert_array_equal(np.asarray(js._apply_min_p(lj, 0.2)),
                                  ts._apply_min_p(lt, 0.2).numpy())
    history = np.full((3, 64), -1, np.int32)
    history[:, -4:] = [[0, 1, 2, 3], [4, 4, 5, 6], [7, 8, 9, 0]]
    jp = js.make_logits_processors({3: 1.5, 10: -2.0}, 1.3, 3)
    tp = ts.make_logits_processors({3: 1.5, 10: -2.0}, 1.3, 3)
    assert len(jp) == len(tp) == 2
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(
            b(torch.from_numpy(history.astype(np.int64)), lt).numpy(),
            np.asarray(a(jnp.asarray(history), lj)), rtol=1e-6, atol=1e-6)
    # seeded draws: reproducible from a generator, and always a kept token
    s = ts.make_sampler(temp=0.8, top_k=3)
    t1 = s(lt, torch.Generator().manual_seed(1))
    t2 = s(lt, torch.Generator().manual_seed(1))
    assert torch.equal(t1, t2)
    top3 = np.argsort(-logits, axis=-1)[:, :3]
    assert all(int(t) in top3[i] for i, t in enumerate(t1))


# K1's plan (row tile, splits) at chip_smoke.py's K1_SHAPES (K, N) for a
# 512-row chunk, g = 64: 256-row tiles, split where their 56 tiles (N = 3584)
# would leave SMs idle; the narrow k/v projection takes 128-row tiles and 8
# slices
K1_PLANS = {(3584, 3584): (256, 2), (3584, 512): (128, 8),
            (3584, 18944): (256, 1), (18944, 3584): (256, 2)}


@pytest.mark.parametrize("K,N", sorted(K1_PLANS))
def test_int4_matmul_plan_at_k1_shapes(K, N):
    n2p = tq._int4_half_width(N)
    assert iv.int4_matmul_plan(512, K, n2p, 64) == K1_PLANS[(K, N)]


@pytest.mark.parametrize("M,K,N,g", [
    (512, 3584, 512, 32), (512, 3584, 512, 128), (100, 3584, 512, 64),
    (9, 256, 200, 64), (64, 3584, 3584, 64), (300, 272, 200, 16),
    (512, 5376, 512, 96), (100, 768, 512, 96), (512, 18944, 3584, 128),
    (17, 128, 4096, 128)])
def test_int4_matmul_plan_slices(M, K, N, g):
    """The split rule: blocks stay at SMS or fewer whenever K is split, and
    every K slice (the kernel's tile ranges z*T/S .. (z+1)*T/S over T
    64-deep stages) holds one quantization group or more."""
    n2p = tq._int4_half_width(N)
    bm, splits = iv.int4_matmul_plan(M, K, n2p, g)
    assert bm in (64, 128, 256) and (bm == 64 or bm < 2 * M) and splits >= 1
    blocks = -(-M // bm) * (n2p // 64)
    assert bm == 64 or blocks >= iv.SMS // 8
    assert splits == 1 or blocks * splits <= iv.SMS
    T = -(-K // 64)
    for z in range(splits):
        t0, t1 = z * T // splits, (z + 1) * T // splits
        assert min(t1 * 64, K) - t0 * 64 >= g
    if splits > 1:  # the largest such count: one more breaks a limit
        s = splits + 1
        assert (blocks * s > iv.SMS or any(
            min((z + 1) * T // s * 64, K) - z * T // s * 64 < g
            for z in range(s)))


@pytest.mark.parametrize("g", [8, 24, 40])
def test_int4_matmul_refuses_group_size_before_launch(g, monkeypatch):
    """A group size with g % 16 != 0 makes the wrapper raise on a tensor
    that is not on the CPU, before any launch; a size it takes gets past
    that check.  Meta tensors stand in for the card's."""
    def no_build():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_cuda, "library", no_build)
    K, n2p = 8 * g, 128

    def weight(gs):
        planes = [torch.empty((K // gs, 1, n2p), device="meta")
                  for _ in range(4)]
        return tq.Int4GroupedTensor(
            torch.empty((K, n2p), dtype=torch.uint8, device="meta"), *planes,
            n=200, group_size=gs, out_dtype="bfloat16")

    x = torch.empty((20, K), dtype=torch.bfloat16, device="meta")
    before = dict(iv.launches)
    with pytest.raises(ValueError, match="g % 16 == 0"):
        iv.int4_matmul(x, weight(g))
    with pytest.raises(ValueError, match="g % 16 == 0"):
        iv.int4_matvec(x, weight(g))
    with pytest.raises(TypeError, match="bfloat16 x on CUDA"):
        iv.int4_matmul(x, weight(g * 2 if g % 16 == 8 else 16))
    assert iv.launches == before


# chip_smoke.py's K2_SHAPES (K, N): the 7B decoder linears and the lm_head
K2_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
             (3584, 152064)]


@pytest.mark.parametrize("K,N", K2_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("g", [16, 32, 64, 128])
def test_int4_matvec_plan_at_k2_shapes(K, N, M, g):
    """K2's plan: the strips x slices give two blocks per SM, or the slices
    are as many as allowed (one group each, or K2_MAX_SLICES, the cluster
    limit); every slice (groups z*G//S .. (z+1)*G//S, as the kernel cuts
    them) is whole groups, one or more, and at most K2_SLICE_ROWS rows
    unless no more slices are allowed; and S is the least count that does
    all this."""
    n2p = tq._int4_half_width(N)
    S = iv.int4_matvec_plan(M, K, n2p, g)
    G, strips = K // g, n2p // 128
    most = min(G, iv.K2_MAX_SLICES)
    assert 1 <= S <= most
    assert strips * S >= 2 * iv.SMS or S == most
    bounds = [z * G // S * g for z in range(S + 1)]
    assert bounds[0] == 0 and bounds[-1] == K
    sizes = [b1 - b0 for b0, b1 in zip(bounds, bounds[1:])]
    assert min(sizes) >= g
    assert max(sizes) <= max(iv.K2_SLICE_ROWS, g) or S == most
    if S > 1:  # one slice fewer breaks a rule
        s = S - 1
        assert strips * s < 2 * iv.SMS or -(-K // s) > iv.K2_SLICE_ROWS


def test_int4_matvec_refuses_before_launch(monkeypatch):
    """K2's wrapper raises on M = 9, on g % 16 != 0 and on x that is not
    bfloat16 on a tensor that is not on the CPU, before any launch; meta
    tensors stand in for the card's."""
    def no_build():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_cuda, "library", no_build)
    K, n2p = 960, 128

    def weight(gs):
        planes = [torch.empty((K // gs, 1, n2p), device="meta")
                  for _ in range(4)]
        return tq.Int4GroupedTensor(
            torch.empty((K, n2p), dtype=torch.uint8, device="meta"), *planes,
            n=200, group_size=gs, out_dtype="bfloat16")

    def x(M, dtype=torch.bfloat16):
        return torch.empty((M, K), dtype=dtype, device="meta")

    before = dict(iv.launches)
    with pytest.raises(ValueError, match="1 to 8 rows"):
        iv.int4_matvec_rows(x(9), weight(64))
    for g in (24, 40):
        with pytest.raises(ValueError, match="g % 16 == 0"):
            iv.int4_matvec_rows(x(1), weight(g))
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(TypeError, match="bfloat16 x on CUDA"):
            iv.int4_matvec_rows(x(4, dtype), weight(64))
    # bf16 x of a taken shape gets past the checks (meta is not CUDA)
    with pytest.raises(TypeError, match="bfloat16 x on CUDA"):
        iv.int4_matvec(x(8), weight(64))
    assert iv.launches == before


def test_cpu_calls_leave_launch_counters_at_zero():
    before = {**iv.launches, **fa.launches}
    t = _port_int4(_jax_int4(64, 128, seed=11))
    iv.int4_matvec(torch.zeros((1, 128)), t)
    iv.int4_matvec(torch.zeros((20, 128)), t)
    x = torch.zeros((1, 2, 8, 128))
    fa.flash_attention(x, x[:, :1], x[:, :1], torch.zeros(1), torch.zeros(1),
                       0.1)
    assert {**iv.launches, **fa.launches} == before
    assert set(before) == {"int4_matmul", "int4_matvec", "flash_attention"}


def test_build_names_existing_sources():
    paths = _cuda.source_paths()
    assert [p.name for p in paths] == list(_cuda.SOURCES)
    for p in paths:
        assert p.is_file(), p
        assert p.suffix == ".cu"
    assert sorted(p.name for p in _cuda.CSRC_DIR.glob("*.cu")) == sorted(
        _cuda.SOURCES)
    # the library name is keyed by the sources, and nothing is built here
    assert _cuda.library_path().parent == _cuda.BUILD_DIR


# ----------------------------------------------------------- on a GPU only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _cuda_int4(K, N, device, g=64):
    t = _port_int4(_jax_int4(N, K, seed=K + N, g=g))
    return tq.Int4GroupedTensor(
        **{f: getattr(t, f).to(device) for f in ("qp", "sl", "sh", "bl", "bh")},
        n=t.n, group_size=g, out_dtype="bfloat16")


# (K, N, g): a narrow weight whose K1 calls split K, a wide one whose calls
# do not (M = 512), K not a multiple of K1's 64-deep stage at g = 16, and a
# ragged n = 1000 (N2p = 512) at K = 4096, whose K2 calls split K into 16
# slices
CUDA_INT4 = [(256, 200, g) for g in (32, 64, 128)] + [
    (512, 4608, g) for g in (32, 64, 128)] + [(272, 200, 16),
                                              (4096, 1000, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,g", CUDA_INT4)
@pytest.mark.parametrize("M", [1, 2, 4, 8, 9, 100, 300, 512])
def test_cuda_int4_kernels_match_plain(cuda_device, M, K, N, g):
    """K2 (M <= 8) and K1 against their plain versions.  Both sides round
    the output once to bf16 (one ulp is at most 2^-7 max|ref|) after f32
    sums that differ by their order only."""
    t = _cuda_int4(K, N, cuda_device, g)
    x = torch.randn((M, K), device=cuda_device).to(torch.bfloat16)
    y = iv.int4_matvec(x, t).float()
    if M > iv.MAX_KERNEL_ROWS:
        ref = iv.int4_matmul_plain(x, t).float()
        tol = 1e-2 * float(ref.abs().max())
    else:
        ref = iv.int4_matvec_plain(x, t).to(torch.bfloat16).float()
        tol = 1e-2 * max(1.0, float(ref.abs().max()))
    torch.cuda.synchronize()
    assert y.shape == (M, N)
    assert float((y - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8])
def test_cuda_int4_matvec_is_bit_identical_across_calls(cuda_device, M):
    """K2 sums its K slices in slice order, whichever block finishes first:
    two calls on the same input give the same bits (16 slices here)."""
    t = _cuda_int4(4096, 1000, cuda_device)
    assert iv.int4_matvec_plan(M, 4096, t.qp.shape[1], 64) > 1
    x = torch.randn((M, 4096), device=cuda_device).to(torch.bfloat16)
    y1 = iv.int4_matvec_rows(x, t)
    y2 = iv.int4_matvec_rows(x, t)
    torch.cuda.synchronize()
    assert y1.dtype == torch.bfloat16 and torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("window,B,H,KVH,S,C,offset,left_pad", [
    pytest.param(None, 2, 8, 2, 96, 256, (150, 100), (0, 7), id="None"),
    pytest.param(100, 2, 8, 2, 96, 256, (150, 100), (0, 7), id="100"),
    # (c)'s first chunk: the causal diagonal cuts every block's last tile
    pytest.param(None, 1, 8, 2, 512, 8704, (0,), (0,), id="S512_offset0"),
])
def test_cuda_flash_attention_matches_plain(cuda_device, window, B, H, KVH,
                                            S, C, offset, left_pad):
    """K4 against its plain version within 2e-2 * max|ref| (the output's
    bf16 rounding and P rounded to bf16 for the second product); a repeat
    call gives the same bits (no split, no atomics)."""
    D = 128
    g = torch.Generator(device="cpu").manual_seed(0)
    # q scaled by 4 sharpens the scores, so a column masked wrongly
    # (left_pad, window) moves the output far past the tolerance
    q, k, v = (torch.randn(s, generator=g).to(cuda_device, torch.bfloat16)
               for s in ((B, H, S, D), (B, KVH, C, D), (B, KVH, C, D)))
    q = q * 4
    off = torch.tensor(offset, dtype=torch.int32, device=cuda_device)
    lp = torch.tensor(left_pad, dtype=torch.int32, device=cuda_device)
    o = fa.flash_attention(q, k, v, off, lp, D**-0.5, window)
    again = fa.flash_attention(q, k, v, off, lp, D**-0.5, window)
    ref = fa.flash_attention_plain(q, k, v, off, lp, D**-0.5, window).float()
    torch.cuda.synchronize()
    assert float((o.float() - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
    assert torch.equal(o, again)
