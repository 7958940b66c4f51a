"""Port parity: quantized weight layouts (mlx_vlm_tpu_torch.core.quant).

The same mlx-format codes, scales and biases (numpy, from a seed) go
through the JAX package and the port; packed bytes and scale planes must be
equal exactly, float results equal to f32 rounding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from mlx_vlm_tpu.core import quant as jq
from mlx_vlm_tpu_torch.core import quant as tq

torch.set_num_threads(2)


def _mlx_tensor(n, k, seed, g=64, bf16=True):
    """Random mlx 4-bit tensor: uint32 codes, scales/biases as numpy
    (bfloat16 via ml_dtypes for the JAX side)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**32, size=(n, k // 8), dtype=np.uint32)
    s = rng.uniform(0.002, 0.006, size=(n, k // g)).astype(np.float32)
    b = (-7.5 * s + rng.normal(0, 1e-3, size=s.shape)).astype(np.float32)
    if bf16:
        s, b = s.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return codes, s, b


def _port_scales(a):
    """numpy (ml_dtypes bf16 or f32) -> the port's host representation."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return a


@pytest.mark.parametrize("n,k", [(64, 128), (200, 256), (513, 64)])
def test_int4_grouped_bytes_equal(n, k):
    codes, s, b = _mlx_tensor(n, k, seed=n + k)
    ref = jq.to_int4_grouped(jq.from_mlx_packed(codes, s, b, 4, 64))
    got = tq.to_int4_grouped(
        tq.from_mlx_packed(codes, _port_scales(s), _port_scales(b), 4, 64))
    assert got.n == ref.n and got.group_size == ref.group_size
    assert got.out_dtype == ref.out_dtype == "bfloat16"
    for f in ("qp", "sl", "sh", "bl", "bh"):
        r, g = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert r.dtype == g.dtype and r.shape == g.shape, f
        assert np.array_equal(r.view(np.uint8), g.view(np.uint8)), f


@pytest.mark.parametrize("n", [100, 128])
def test_half_width_matches(n):
    assert tq._int4_half_width(n) == jq._int4_half_width(n)
    assert tq._int4_half_width(n) % 128 == 0


@pytest.mark.parametrize("chunk_rows", [8192, 7])
def test_channel_fold_equal(chunk_rows):
    codes, s, b = _mlx_tensor(96, 128, seed=3)
    ref = jq.to_channel_quantized(jq.from_mlx_packed(codes, s, b, 4, 64))
    got = tq.to_channel_quantized(
        tq.from_mlx_packed(codes, _port_scales(s), _port_scales(b), 4, 64),
        chunk_rows=chunk_rows)
    assert np.array_equal(np.asarray(ref.q8), got.q8.numpy())
    assert got.scales.dtype == torch.bfloat16
    for f in ("scales", "biases"):
        r = np.asarray(getattr(ref, f)).astype(np.float32)
        g = getattr(got, f).float().numpy()
        assert np.array_equal(r, g), f
    assert got.shape == ref.shape and got.src_bits == ref.src_bits


def test_int4_grouped_dequantize_matches():
    codes, s, b = _mlx_tensor(130, 192, seed=5, bf16=False)
    ref = jq.to_int4_grouped(jq.from_mlx_packed(codes, s, b, 4, 64))
    got = tq.to_int4_grouped(tq.from_mlx_packed(codes, s, b, 4, 64))
    wr = np.asarray(jq.int4_grouped_dequantize(ref, jnp.float32))
    wg = tq.int4_grouped_dequantize(got, torch.float32).numpy()
    assert wg.shape == (130, 192)
    np.testing.assert_allclose(wg, wr, rtol=1e-6, atol=1e-7)
    # and it is the mlx affine dequant of the source codes
    qt = tq.from_mlx_packed(codes, s, b, 4, 64)
    np.testing.assert_allclose(tq.dequantize(qt, torch.float32).numpy(), wr,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_dequantize_match(bits):
    w = np.random.default_rng(bits).standard_normal((48, 128)).astype(np.float32)
    ref = jq.quantize(jnp.asarray(w), bits=bits, group_size=64)
    got = tq.quantize(torch.from_numpy(w), bits=bits, group_size=64)
    assert np.array_equal(np.asarray(ref.q), got.q.numpy())
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(ref.scales),
                               rtol=1e-6)
    np.testing.assert_allclose(tq.dequantize(got).numpy(),
                               np.asarray(jq.dequantize(ref)), rtol=1e-6,
                               atol=1e-6)
    assert got.shape == ref.shape and got.out_dtype == "float32"


def test_int4_layer_views_share_storage():
    codes, s, b = _mlx_tensor(64, 128, seed=9, bf16=False)
    one = tq.to_int4_grouped(tq.from_mlx_packed(codes, s, b, 4, 64))
    stacked = tq.Int4GroupedTensor(
        **{f: torch.from_numpy(np.stack([getattr(one, f)] * 3))
           for f in ("qp", "sl", "sh", "bl", "bh")},
        n=one.n, group_size=64, out_dtype="float32")
    view = stacked.layer(1)
    assert view.qp.data_ptr() == stacked.qp[1].data_ptr()
    assert view.shape == (64, 128) and stacked.ndim == 3


def test_host_array_bf16_widening():
    x = np.array([1.5, -2.25, 3e-3], np.float32)
    jb = x.astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(tq.host_array(jb), jb.astype(np.float32))
    assert np.array_equal(tq.host_array(t), jb.astype(np.float32))
    assert tq.dtype_name(t) == tq.dtype_name(jb) == "bfloat16"
