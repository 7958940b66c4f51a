"""Port parity: the per-channel int8 fold (w8chan) as torch float64 ops on
the load's device (core/quant.py `to_channel_quantized`, utils/loader.py
`_fold_quantized`).

The same mlx codes, scales and biases (numpy, from a seed) go through the
JAX package's host fold (core/quant.py:114) and the port's; codes, scales
and biases must be equal byte for byte: at 4 and 8 bits, at each group
size the loader takes, with rows of one value (a zero range, scale 1) and
with codes that land on halves (round half to even), in chunks of rows of
any size.  On a card (`-m cuda`) the fold on the device is held to the
fold on the CPU, byte for byte, at a vocab-sized table.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_vlm_tpu.core import quant as jq
from mlx_vlm_tpu.utils import loader as jl
from mlx_vlm_tpu_torch.core import quant as tq
from mlx_vlm_tpu_torch.utils import loader as tl

torch.set_num_threads(2)


def _triple(n, k, bits, g, seed, bf16=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**32, size=(n, k * bits // 32), dtype=np.uint32)
    s = rng.uniform(0.002, 0.006, size=(n, k // g)).astype(np.float32)
    b = (-7.5 * s + rng.normal(0, 1e-3, size=s.shape)).astype(np.float32)
    codes[0] = 0  # a row of one value: zero range, scale 1
    s[1] = 0.5  # exact halves after the affine step
    b[1] = 0.25
    if bf16:
        s, b = s.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return codes, s, b


def _port(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return a


def _same(ref, got):
    assert np.array_equal(np.asarray(ref.q8), got.q8.cpu().numpy())
    for f in ("scales", "biases"):
        r = np.asarray(getattr(ref, f))
        g = getattr(got, f).cpu()
        if g.dtype == torch.bfloat16:
            g = g.view(torch.uint16).numpy()
            r = r.view(np.uint16)
        else:
            g = g.numpy()
        assert r.dtype == g.dtype and np.array_equal(r, g), f
    assert got.shape == ref.shape and got.src_bits == ref.src_bits


@pytest.mark.parametrize("bits,g", [(4, 32), (4, 64), (4, 128), (8, 64),
                                    (8, 128)])
@pytest.mark.parametrize("chunk_rows", [8192, 5])
def test_fold_bytes_equal_the_reference(bits, g, chunk_rows):
    codes, s, b = _triple(37, 256, bits, g, seed=bits * 100 + g)
    ref = jq.to_channel_quantized(jq.from_mlx_packed(codes, s, b, bits, g))
    got = tq.to_channel_quantized(
        tq.from_mlx_packed(codes, _port(s), _port(b), bits, g),
        chunk_rows=chunk_rows, device="cpu")
    assert got.q8.device.type == "cpu"
    _same(ref, got)


def test_fold_f32_scales_equal_the_reference():
    codes, s, b = _triple(16, 128, 4, 64, seed=9, bf16=False)
    ref = jq.to_channel_quantized(jq.from_mlx_packed(codes, s, b, 4, 64))
    got = tq.to_channel_quantized(tq.from_mlx_packed(codes, s, b, 4, 64))
    _same(ref, got)


@pytest.mark.parametrize("mode", ["w8chan", "w4grp"])
def test_loader_fold_on_the_load_device(mode):
    """`_fold_quantized(..., device)`: every per-channel triple (w8chan's
    linears, w4grp's embedding table) comes out on the device, byte for
    byte the reference's."""
    codes, s, b = _triple(64, 128, 4, 64, seed=4)
    flat = {"model.embed_tokens.weight": codes,
            "model.embed_tokens.scales": s,
            "model.embed_tokens.biases": b,
            "model.layers.0.mlp.up_proj.weight": codes,
            "model.layers.0.mlp.up_proj.scales": s,
            "model.layers.0.mlp.up_proj.biases": b}
    qcfg = {"bits": 4, "group_size": 64}
    ref = jl._fold_quantized(dict(flat), qcfg, mode)
    got = tl._fold_quantized({k: _port(v) if k.endswith(("scales", "biases"))
                              else v for k, v in flat.items()}, qcfg, mode,
                             torch.device("cpu"))
    for k, r in ref.items():
        if type(r).__name__ == "ChannelQuantizedTensor":
            assert type(got[k]).__name__ == "ChannelQuantizedTensor", k
            _same(r, got[k])


@pytest.mark.cuda
def test_fold_on_the_card_equals_the_host():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    codes, s, b = _triple(128256, 4096, 4, 64, seed=1)
    t = tq.from_mlx_packed(codes, _port(s), _port(b), 4, 64)
    host = tq.to_channel_quantized(t, device="cpu")
    card = tq.to_channel_quantized(t, device="cuda")
    assert card.q8.device.type == "cuda"
    assert torch.equal(host.q8, card.q8.cpu())
    for f in ("scales", "biases"):
        assert torch.equal(getattr(host, f).view(torch.int16),
                           getattr(card, f).cpu().view(torch.int16)), f
