"""Port parity: attention sinks (gpt-oss's one learned f32 logit per head)
in `sdpa` and in every cache's `attend`, against the JAX package, in
float32 on the CPU on numpy-seeded inputs.

- `sdpa` with sinks, with and without a soft-cap, and with a left-padded
  row whose every key is masked (the sink then takes all the mass and the
  output stays finite: zeros): within 1e-6 of max|ref|;
- each cache's attend with sinks (bf16 layout `KVCache` in f32, the
  group-affine `QuantizedKVCache`, `Int8KVCache`, `Int4KVCache`, the
  rotated int4 cache and both TurboQuant codebook caches), a 12-token
  prefill and two decode steps: both sides run plain math, so within 1e-5
  of max|ref| (1e-4 for the codebook caches, whose Hadamard rotations sum
  in another order);
- the route rules: under sinks no cache reaches K4, K6, K7 or K8 (the
  kernels' wrappers replaced by ones that raise, each shown to be reached
  without sinks).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlx_vlm_tpu.core import cache as jcache
from mlx_vlm_tpu.core import turboquant as jtq
from mlx_vlm_tpu.core.mask import causal_cache_mask as jax_mask
from mlx_vlm_tpu.ops.attention import sdpa as jax_sdpa
from mlx_vlm_tpu_torch.core import cache as tcache
from mlx_vlm_tpu_torch.core import turboquant as ttq
from mlx_vlm_tpu_torch.core.mask import causal_cache_mask
from mlx_vlm_tpu_torch.ops.attention import sdpa

NH, NKV, D, C = 4, 2, 64, 32


def _inputs(seed, S, Ck, B=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NH, S, D)).astype(np.float32)
    k = rng.standard_normal((B, NKV, Ck, D)).astype(np.float32)
    v = rng.standard_normal((B, NKV, Ck, D)).astype(np.float32)
    sinks = (rng.standard_normal(NH) * 2).astype(np.float32)
    return q, k, v, sinks


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_sdpa_with_sinks_matches_reference(softcap):
    """Row 1 is left-padded past its last query (every key masked on its
    first rows): the sink takes all their mass, the output is 0 there."""
    S = Ck = 6
    q, k, v, sinks = _inputs(1, S, Ck)
    lp = np.array([0, 4], np.int32)
    jm = jax_mask(jnp.asarray(0, jnp.int32), jnp.asarray(lp), S, Ck)
    tm = causal_cache_mask(0, torch.from_numpy(lp), S, Ck)
    ref = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              D**-0.5, jm, logit_softcap=softcap,
                              sinks=jnp.asarray(sinks)))
    got = sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               D**-0.5, tm, softcap, torch.from_numpy(sinks)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    assert np.abs(got[1, :, :3]).max() == 0.0  # fully masked rows
    plain = sdpa(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), D**-0.5, tm, softcap).numpy()
    assert not np.allclose(plain[0], got[0], atol=1e-3)


def _caches(kind):
    """(JAX cache, port cache, tolerance) of one kind, 1 layer, 2 rows,
    left pads (0, 3)."""
    lpj, lpt = jnp.asarray([0, 3], jnp.int32), torch.tensor([0, 3])
    dims = (1, 2, NKV, D, C)
    if kind == "bf16":
        return (jcache.init_cache(*dims, jnp.float32, left_pad=lpj),
                tcache.init_cache(*dims, torch.float32, left_pad=lpt), 1e-5)
    if kind == "affine4":
        return (jcache.init_quantized_cache(*dims, jnp.float32, bits=4,
                                            group_size=32, left_pad=lpj),
                tcache.init_quantized_cache(*dims, torch.float32, bits=4,
                                            group_size=32, left_pad=lpt),
                1e-5)
    if kind == "int8":
        return (jcache.init_int8_cache(*dims, left_pad=lpj),
                tcache.init_int8_cache(*dims, left_pad=lpt), 1e-5)
    if kind == "int4":
        return (jcache.init_int4_cache(*dims, left_pad=lpj),
                tcache.init_int4_cache(*dims, left_pad=lpt), 1e-5)
    if kind == "rotated_int4":
        return (jtq.make_rotated_int4_cache(*dims, left_pad=lpj),
                ttq.make_rotated_int4_cache(*dims, left_pad=lpt), 1e-4)
    if kind == "tq3.5":
        return (jtq.init_turboquant_cache(*dims, 3.5, left_pad=lpj),
                ttq.init_turboquant_cache(*dims, 3.5, left_pad=lpt), 1e-4)
    return (jtq.init_turboquant_split_cache(*dims, 3.5, left_pad=lpj),
            ttq.init_turboquant_split_cache(*dims, 3.5, left_pad=lpt), 1e-4)


KINDS = ("bf16", "affine4", "int8", "int4", "rotated_int4", "tq3.5",
         "tq3.5split")


@pytest.mark.parametrize("kind", KINDS)
def test_cache_attend_with_sinks_matches_reference(kind):
    jc, tc, tol = _caches(kind)
    rng = np.random.default_rng(5)
    sinks = (rng.standard_normal(NH) * 2).astype(np.float32)
    lp = np.array([0, 3], np.int32)
    for s in (12, 1, 1):
        q = rng.standard_normal((2, NH, s, D)).astype(np.float32)
        k = rng.standard_normal((2, NKV, s, D)).astype(np.float32)
        v = rng.standard_normal((2, NKV, s, D)).astype(np.float32)
        jm = jax_mask(jc.offset, jnp.asarray(lp), s, jc.capacity)
        cxs = tuple(a[0] for a in jc.scan_arrays())
        ref, new = jc.attend(cxs, jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), D**-0.5, jm,
                             sinks=jnp.asarray(sinks))
        jc = jc.with_arrays(tuple(a[None] for a in new), s)
        tm = causal_cache_mask(tc.offset, torch.from_numpy(lp), s,
                               tc.capacity)
        got = tc.attend(0, torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), D**-0.5, tm,
                        sinks=torch.from_numpy(sinks))
        tc.advance(s)
        ref = np.asarray(ref)
        assert got.shape == ref.shape and np.all(np.isfinite(got.numpy()))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())


def _kernels_raise(monkeypatch):
    """Every attention kernel's wrapper replaced by one that raises, and
    K4's shape rule made to pass on the CPU."""
    from mlx_vlm_tpu_torch.ops import flash_attention as k4
    from mlx_vlm_tpu_torch.ops import int4_kv_attention as k6
    from mlx_vlm_tpu_torch.ops import tq_kv_attention as k78

    class Reached(Exception):
        pass

    def boom(*a, **k):
        raise Reached

    monkeypatch.setattr(k4, "flash_attention", boom)
    monkeypatch.setattr(k6, "int4_kv_decode_attention", boom)
    monkeypatch.setattr(k78, "tq_kv_decode_attention", boom)
    monkeypatch.setattr(k78, "tq_kv_decode_attention_split", boom)
    monkeypatch.setattr(tcache, "flash_eligible", lambda q, k: True)
    return Reached


@pytest.mark.parametrize("kind", ("bf16", "int4", "rotated_int4", "tq3.5",
                                  "tq3.5split"))
def test_sinks_keep_every_kernel_off(monkeypatch, kind):
    """Without sinks the cache's step reaches its kernel (K4 for a bf16
    prefill chunk, K6 / K7 / K8 for a decode step); with sinks it takes
    the plain route."""
    Reached = _kernels_raise(monkeypatch)
    _, tc, _ = _caches(kind)
    s = 4 if kind == "bf16" else 1
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, h, s, D)).astype(np.float32)) for h in (NH, NKV, NKV))
    mask = causal_cache_mask(tc.offset, tc.left_pad, s, tc.capacity)
    with pytest.raises(Reached):
        tc.attend(0, q, k, v, D**-0.5, mask)
    out = tc.attend(0, q, k, v, D**-0.5, mask,
                    sinks=torch.zeros(NH))
    assert out.shape == (2, NH, s, D)
    assert not tcache.int4_kv_route(1, D, sinks=torch.zeros(NH))
    assert tcache.int4_kv_route(1, D)
