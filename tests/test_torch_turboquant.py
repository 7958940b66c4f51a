"""Port parity: the TurboQuant codec, caches and kernels K7 / K8.

The codec (Lloyd-Max levels, bit-plane packing, Hadamard rotation, random
signs, encode) is held to the JAX package's exactly or within the stated
float bound; the plain versions of K7 and K8 to the Pallas kernels in
interpret mode; the TurboQuant and split caches to the reference's
`attend`, prefill then decode.  Inputs are made with numpy from a seed and
handed to both packages, which run in float32 on the CPU.  Tests marked
`cuda` hold the CUDA kernels to their plain versions on a GPU and skip
without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlx_vlm_tpu.core import turboquant as jtq
from mlx_vlm_tpu.ops import tq_kv_attention as jk
from mlx_vlm_tpu_torch.core import turboquant as ttq
from mlx_vlm_tpu_torch.ops import tq_kv_attention as tk

from test_torch_kv_quant import (BH, C, G, PALLAS, PREFILL, ROW_LEFT_PAD,
                                 ROW_OFFSETS, _buffers_equal, _check_outputs,
                                 cache_steps, pad_rows)

torch.set_num_threads(2)


# ------------------------------------------------------------ the codec


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_unpack_codes_equal(bits):
    codes = np.random.default_rng(bits).integers(
        0, 1 << bits, (3, 5, 64)).astype(np.uint8)
    ref = np.asarray(jtq.pack_codes(jnp.asarray(codes), bits))
    got = ttq.pack_codes(torch.from_numpy(codes), bits).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    back = ttq.unpack_codes(torch.from_numpy(ref.copy()), bits).numpy()
    assert np.array_equal(back, codes)
    assert np.array_equal(back, np.asarray(jtq.unpack_codes(jnp.asarray(ref),
                                                            bits)))


@pytest.mark.parametrize("bits", range(1, 9))
def test_levels_boundaries_equal(bits):
    assert np.array_equal(ttq._levels(bits), jtq._levels(bits))
    assert np.array_equal(ttq._boundaries(bits).numpy(),
                          np.asarray(jtq._boundaries(bits)))


@pytest.mark.parametrize("d", [8, 64, 128, 256])
def test_signs_and_hadamard(d):
    assert np.array_equal(ttq._signs(d).numpy(), np.asarray(jtq._signs(d)))
    x = np.random.default_rng(d).standard_normal((4, 3, d)).astype(np.float32)
    ref = np.asarray(jtq.hadamard_transform(jnp.asarray(x)))
    got = ttq.hadamard_transform(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ttq.hadamard_transform(torch.from_numpy(got))
                               .numpy(), x, rtol=0, atol=1e-5)


def _codes_match(got_p, ref_p, bits, xn_ref, bounds):
    """Codes equal except where the reference's normalized value lies within
    1e-5 of a decision boundary (a float-order tie)."""
    got = ttq.unpack_codes(torch.from_numpy(got_p), bits).numpy()
    ref = np.asarray(jtq.unpack_codes(jnp.asarray(ref_p), bits))
    near = np.abs(xn_ref[..., None] - bounds).min(-1) < 1e-5
    assert np.all((got == ref) | near)


@pytest.mark.parametrize("bits,hd", [(3, 128), (4, 128), (2, 96), (6, 128)])
def test_tq_encode_matches(bits, hd):
    x = np.random.default_rng(bits + hd).standard_normal(
        (2, 3, 5, hd)).astype(np.float32)
    p2 = ttq._pow2(hd)
    js, ts = jtq._signs(p2), ttq._signs(p2)
    rp, rs = jtq.tq_encode(jnp.asarray(x), bits, js)
    gp, gs = ttq.tq_encode(torch.from_numpy(x), bits, ts)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-6)
    xr = np.asarray(jtq.hadamard_transform(
        jnp.pad(jnp.asarray(x), [(0, 0)] * 3 + [(0, p2 - hd)]) * js))
    _codes_match(gp.numpy(), np.asarray(rp), bits,
                 xr / np.asarray(rs)[..., None], np.asarray(jtq._boundaries(bits)))
    ref = np.asarray(jtq.tq_decode_headdim(rp, rs, bits, js, hd))
    got = ttq.tq_decode_headdim(torch.from_numpy(np.asarray(rp)),
                                torch.from_numpy(np.asarray(rs)), bits, ts,
                                hd).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_bits", [3.5, 4.5])
def test_tq_encode_split_matches(kv_bits):
    hd = 128
    lo, hi = int(np.floor(kv_bits)), int(np.ceil(kv_bits))
    d_hi = int(round((kv_bits - lo) * hd / 8)) * 8
    x = np.random.default_rng(int(kv_bits * 2)).standard_normal(
        (2, 3, 5, hd)).astype(np.float32)
    js, ts = jtq._signs(hd), ttq._signs(hd)
    ref = jtq.tq_encode_split(jnp.asarray(x), lo, hi, d_hi, js)
    got = ttq.tq_encode_split(torch.from_numpy(x), lo, hi, d_hi, ts)
    xr = np.asarray(jtq.hadamard_transform(jnp.asarray(x) * js))
    segs = (xr[..., :hd - d_hi], xr[..., hd - d_hi:])
    for seg, bits, (gp, gs), (rp, rs) in zip(segs, (lo, hi),
                                             (got[:2], got[2:]),
                                             (ref[:2], ref[2:])):
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-6)
        _codes_match(gp.numpy(), np.asarray(rp), bits,
                     seg / np.asarray(rs)[..., None],
                     np.asarray(jtq._boundaries(bits)))
    dec_ref = np.asarray(jtq.tq_decode_split(*ref, lo, hi, js, hd))
    dec = ttq.tq_decode_split(*(torch.from_numpy(np.asarray(a)) for a in ref),
                              lo, hi, ts, hd).numpy()
    np.testing.assert_allclose(dec, dec_ref, rtol=0, atol=1e-5)


# ------------------------------------------------------------ K7 and K8


def tq_inputs(D, k_bits, v_bits, seed, q_scale=1.0, g=G):
    """Random K7 inputs over the whole capacity: the codes and scales past
    each cursor are garbage the kernel must not read."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, g, D)).astype(np.float32) * q_scale
    kq = rng.integers(0, 256, (BH, C, D * k_bits // 8), dtype=np.uint8)
    vq = rng.integers(0, 256, (BH, C, D * v_bits // 8), dtype=np.uint8)
    ks, vs = (rng.uniform(0.5, 1.5, (BH, C)).astype(np.float32)
              for _ in range(2))
    return q, kq, ks, vq, vs


def _cursors(rows):
    if rows == "scalar":
        return np.int32(150), np.full((BH,), 20, np.int32)
    return ROW_OFFSETS, ROW_LEFT_PAD


def _port_cursor(off):
    return int(off) if off.ndim == 0 else torch.from_numpy(off)


@pytest.mark.parametrize("k_bits,v_bits", [(3, 4), (3, 3), (5, 5), (6, 6)])
@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_k7_plain_matches_pallas(k_bits, v_bits, rows):
    """Tolerance PALLAS (1e-3 * max|ref|): both round q, the decoded codes
    and p * vs to bf16; f32 exp and sums may flip a single rounding."""
    D = 128
    q, kq, ks, vq, vs = tq_inputs(D, k_bits, v_bits, seed=k_bits * 10 + v_bits)
    off, lp = _cursors(rows)
    kl, vl = jtq._levels(k_bits), jtq._levels(v_bits)
    ref = np.asarray(jk.tq_kv_decode_attention(
        jnp.asarray(pad_rows(q)), jnp.asarray(kq), jnp.asarray(ks),
        jnp.asarray(vq), jnp.asarray(vs), jnp.asarray(off), D ** -0.5,
        k_bits, v_bits, kl, vl, left_pad=jnp.asarray(lp),
        interpret=True))[:, :G]
    got = tk.tq_kv_decode_attention(
        *(torch.from_numpy(a) for a in (q, kq, ks, vq, vs)),
        _port_cursor(off), D ** -0.5, k_bits, v_bits, ttq._levels(k_bits),
        ttq._levels(v_bits), left_pad=torch.from_numpy(lp)).numpy()
    assert got.shape == (BH, G, D)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=PALLAS * np.abs(ref).max())


def split_inputs(kv_bits, seed, q_scale=1.0, g=G):
    D = 128
    lo, hi = int(np.floor(kv_bits)), int(np.ceil(kv_bits))
    d_hi = int(round((kv_bits - lo) * D / 8)) * 8
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, g, D)).astype(np.float32) * q_scale
    arrs = []
    for width in ((D - d_hi) * lo // 8, d_hi * hi // 8) * 2:
        arrs.append(rng.integers(0, 256, (BH, C, width), dtype=np.uint8))
        arrs.append(rng.uniform(0.5, 1.5, (BH, C)).astype(np.float32))
    return q, arrs, lo, hi


@pytest.mark.parametrize("kv_bits", [3.5, 4.5])
@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_k8_plain_matches_pallas(kv_bits, rows):
    """Tolerance PALLAS, as for K7."""
    q, arrs, lo, hi = split_inputs(kv_bits, seed=int(kv_bits * 10))
    off, lp = _cursors(rows)
    D = q.shape[-1]
    ref = np.asarray(jk.tq_kv_decode_attention_split(
        jnp.asarray(pad_rows(q)), *(jnp.asarray(a) for a in arrs),
        jnp.asarray(off), D ** -0.5, lo, hi, jtq._levels(lo), jtq._levels(hi),
        left_pad=jnp.asarray(lp), interpret=True))[:, :G]
    got = tk.tq_kv_decode_attention_split(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in arrs),
        _port_cursor(off), D ** -0.5, lo, hi, ttq._levels(lo),
        ttq._levels(hi), left_pad=torch.from_numpy(lp)).numpy()
    assert got.shape == (BH, G, D)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=PALLAS * np.abs(ref).max())


# ------------------------------------------------------------ the caches

# the caches' left_pad, as in the masks cache_steps builds
LP_J = {"left_pad": jnp.asarray([3], jnp.int32)}
LP_T = {"left_pad": torch.tensor([3])}


@pytest.mark.parametrize("kind,kv_bits", [("turboquant", 3.5),
                                          ("turboquant", 3.0),
                                          ("split", 3.5)])
def test_tq_caches_match_reference(kind, kv_bits):
    """Prefill then two decode steps through both packages' attend.  Codes
    and scales are written identically; prefill runs the same f32 math on
    both sides, and decode the packed-code kernel (the reference's Pallas
    kernel in interpret mode, the port's plain version), so PALLAS holds."""
    D = 128
    if kind == "split":
        j = jtq.init_turboquant_split_cache(1, 1, 2, D, C, kv_bits, **LP_J)
        t = ttq.init_turboquant_split_cache(1, 1, 2, D, C, kv_bits, **LP_T)
        fields = ("kqa", "ksa", "kqb", "ksb", "vqa", "vsa", "vqb", "vsb")
    else:
        j = jtq.init_turboquant_cache(1, 1, 2, D, C, kv_bits, **LP_J)
        t = ttq.init_turboquant_cache(1, 1, 2, D, C, kv_bits, **LP_T)
        fields = ("kq", "kscale", "vq", "vscale")
    outs, j, t = cache_steps(j, t, D, seed=int(kv_bits * 10))
    assert int(t.offset) == int(j.offset) == 42
    _buffers_equal(j, t, fields)
    _check_outputs(outs, PALLAS)


def test_tq_fused_switch_takes_dequant_route(monkeypatch):
    """MLX_VLM_TPU_TQ_FUSED=0 decodes the cache and runs sdpa, on both
    sides; the outputs then agree at f32 order (PREFILL)."""
    monkeypatch.setenv("MLX_VLM_TPU_TQ_FUSED", "0")
    D = 128
    j = jtq.init_turboquant_cache(1, 1, 2, D, C, 3.5, **LP_J)
    t = ttq.init_turboquant_cache(1, 1, 2, D, C, 3.5, **LP_T)
    outs, j, t = cache_steps(j, t, D, seed=5)
    _check_outputs(outs, PREFILL)


def test_tq_8bit_decode_matches_reference_dequant_route(monkeypatch):
    """8-bit codes are stored as raw bytes (pack_codes).  The reference's
    Pallas kernel reads them as bit planes and disagrees with its own
    dequantize route (ROADMAP Queue 3, known faults in the reference); the
    port's K7 decodes raw bytes, so its decode is held to the reference's
    dequantize + sdpa route.  Tolerance ROUNDED (3e-2 * max|ref|, from
    test_torch_kv_quant): the kernel rounds q, the decoded values and
    p * vs to bf16, which that route does not."""
    from test_torch_kv_quant import ROUNDED

    monkeypatch.setenv("MLX_VLM_TPU_TQ_FUSED", "0")  # the reference's route
    monkeypatch.setattr(ttq, "fused_route_on", lambda: True)  # the port's K7
    D = 128
    j = jtq.init_turboquant_cache(1, 1, 2, D, C, 8.0, **LP_J)
    t = ttq.init_turboquant_cache(1, 1, 2, D, C, 8.0, **LP_T)
    outs, j, t = cache_steps(j, t, D, seed=8)
    _buffers_equal(j, t, ("kq", "kscale", "vq", "vscale"))
    _check_outputs(outs, ROUNDED)


def test_cpu_calls_leave_tq_counters_at_zero():
    before = dict(tk.launches)
    q, kq, ks, vq, vs = tq_inputs(128, 3, 4, seed=1)
    tk.tq_kv_decode_attention(*(torch.from_numpy(a) for a in
                                (q, kq, ks, vq, vs)), 10, 0.1, 3, 4,
                              ttq._levels(3), ttq._levels(4))
    assert tk.launches == before == {"tq_kv_attention": 0,
                                     "tq_kv_attention_split": 0}


# ----------------------------------------------------------- on a GPU only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _cuda_cursors(rows, dev):
    off, lp = _cursors(rows)
    off = int(off) if off.ndim == 0 else torch.from_numpy(off).to(dev)
    return off, torch.from_numpy(lp).to(dev)


# On the card the kernels round p * vs to bf16 against a split-local
# maximum instead of the global one: 1e-2 * max|ref|, q sharpened by 4.
CUDA_TOL = 1e-2


# query rows per KV head: Qwen2-VL-2B's 6, 7B's 7, and 12 (two n-tiles)
@pytest.mark.cuda
@pytest.mark.parametrize("g", [6, 7, 12])
@pytest.mark.parametrize("k_bits,v_bits", [(3, 4), (3, 3), (5, 5), (6, 6),
                                           (8, 8)])
@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_cuda_k7_matches_plain(cuda_device, k_bits, v_bits, rows, g):
    D = 128
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in tq_inputs(D, k_bits, v_bits, seed=3, q_scale=4.0, g=g)]
    off, lp = _cuda_cursors(rows, cuda_device)
    luts = (ttq._levels(k_bits), ttq._levels(v_bits))
    n0 = tk.launches["tq_kv_attention"]
    got = tk.tq_kv_decode_attention(*arrs, off, D ** -0.5, k_bits, v_bits,
                                    *luts, left_pad=lp)
    ref = tk.tq_kv_decode_attention_plain(
        *arrs, tk._rows(off, BH, cuda_device), D ** -0.5, k_bits, v_bits,
        *luts, lp)
    torch.cuda.synchronize()
    assert tk.launches["tq_kv_attention"] == n0 + 1
    assert float((got - ref).abs().max()) <= CUDA_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("g", [6, 7, 12])
@pytest.mark.parametrize("kv_bits", [3.5, 4.5, 3.05, 3.95])
@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_cuda_k8_matches_plain(cuda_device, kv_bits, rows, g):
    q, arrs, lo, hi = split_inputs(kv_bits, seed=4, q_scale=4.0, g=g)
    q = torch.from_numpy(q).to(cuda_device)
    arrs = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    off, lp = _cuda_cursors(rows, cuda_device)
    D = q.shape[-1]
    luts = (ttq._levels(lo), ttq._levels(hi))
    n0 = tk.launches["tq_kv_attention_split"]
    got = tk.tq_kv_decode_attention_split(q, *arrs, off, D ** -0.5, lo, hi,
                                          *luts, left_pad=lp)
    ref = tk.tq_kv_decode_attention_split_plain(
        q, *arrs, tk._rows(off, BH, cuda_device), D ** -0.5, lo, hi, *luts,
        lp)
    torch.cuda.synchronize()
    assert tk.launches["tq_kv_attention_split"] == n0 + 1
    assert float((got - ref).abs().max()) <= CUDA_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_tq_repeat_is_bit_identical_and_leaves_counters_zero(
        cuda_device):
    """A second call gives the same bits (the splits are combined in a
    fixed order), and the per-card counters are back at zero after it."""
    q, arrs, lo, hi = split_inputs(3.5, seed=6, q_scale=4.0)
    q = torch.from_numpy(q).to(cuda_device)
    arrs = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    off, lp = _cuda_cursors("per_row", cuda_device)
    luts = (ttq._levels(lo), ttq._levels(hi))
    outs = [tk.tq_kv_decode_attention_split(q, *arrs, off, 128 ** -0.5, lo,
                                            hi, *luts, left_pad=lp)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert not tk._tickets(q.device, 1).any()
