"""Port parity: K5, the mlx group-affine linear (ops/qmatmul.py).

The port's plain version is held to the reference's Pallas kernel run in
interpret mode (as tests/test_qmatmul.py runs it), for 4- and 8-bit codes,
group sizes 32 / 64 / 128, 1 to 70 rows, leading dims, and x in float32 and
bfloat16.  The port's route rule is held to the reference's, and the
dequantize route to the reference's `quantized_matmul` on the CPU.  Inputs
are made with numpy from a seed and handed to both packages.  Tests marked
`cuda` hold the CUDA kernel to its plain version on a GPU and skip without
one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from mlx_vlm_tpu.core import quant as jq
from mlx_vlm_tpu.ops import qmatmul as jqmm
from mlx_vlm_tpu_torch.core import quant as tq
from mlx_vlm_tpu_torch.ops import qmatmul as k5

torch.set_num_threads(2)

K, N = 256, 192


def mlx_weight(bits, g, seed, n=N, k=K, bf16=False):
    """(q u8 [n, k*bits/8], scales, biases [n, k/g]) as numpy: codes uniform
    over [0, 2**bits), bias -((2**bits - 1)/2) * scale (the layout of an mlx
    checkpoint); scales in bfloat16 (ml_dtypes) when `bf16`."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (n, k * bits // 8), dtype=np.uint8)
    s = rng.uniform(0.01, 0.03, (n, k // g)).astype(np.float32)
    b = (-((2**bits - 1) / 2) * s
         + rng.normal(0, 1e-3, s.shape)).astype(np.float32)
    if bf16:
        s, b = s.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return q, s, b


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def both(q, s, b, bits, g):
    """The same weight as a reference and as a port QuantizedTensor."""
    name = np.dtype(s.dtype).name
    ref = jq.QuantizedTensor(q=jnp.asarray(q), scales=jnp.asarray(s),
                             biases=jnp.asarray(b), bits=bits, group_size=g,
                             out_dtype=name)
    got = tq.QuantizedTensor(q=_torch(q), scales=_torch(s), biases=_torch(b),
                             bits=bits, group_size=g, out_dtype=name)
    return ref, got


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _tol(ref, dtype):
    """f32: reassociation only.  bf16: both round once at the end, so they
    differ by at most one bf16 ulp of max|ref| (2**-7 * max|ref|)."""
    m = float(np.abs(ref).max())
    return 1e-5 * max(1.0, m) if dtype == "float32" else 2.0**-7 * m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 3, 8, 9, 70])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_k5_plain_matches_pallas(bits, g, M, dtype):
    q, s, b = mlx_weight(bits, g, seed=bits * 1000 + g + M,
                         bf16=dtype == "bfloat16")
    ref_t, t = both(q, s, b, bits, g)
    x = _x((M, K), dtype, seed=M + g)
    ref = np.asarray(jqmm.quantized_matmul_pallas(jnp.asarray(x), ref_t,
                                                  interpret=True))
    got = k5.quantized_matmul_kernel(_torch(x), t)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    assert tuple(got.shape) == ref.shape == (M, N)
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(ref, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_k5_lead_dims_match_pallas(bits, dtype):
    q, s, b = mlx_weight(bits, 64, seed=bits, bf16=dtype == "bfloat16")
    ref_t, t = both(q, s, b, bits, 64)
    x = _x((2, 3, K), dtype, seed=bits)
    ref = np.asarray(jqmm.quantized_matmul_pallas(jnp.asarray(x), ref_t,
                                                  interpret=True))
    got = k5.quantized_matmul_kernel(_torch(x), t)
    assert tuple(got.shape) == ref.shape == (2, 3, N)
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(ref, dtype))


# (bits, group size, in-features, stacked): K5-eligible or not by the
# reference's rule (packed row bytes a multiple of the group)
ROUTE_CASES = [(4, 32, 64, False), (4, 64, 64, False), (4, 64, 192, False),
               (4, 64, 256, False), (8, 64, 64, False), (8, 32, 96, False),
               (2, 32, 128, False), (4, 32, 64, True)]


@pytest.mark.parametrize("bits,g,k,stacked", ROUTE_CASES)
@pytest.mark.parametrize("transpose", [True, False])
def test_route_rule_matches_reference(monkeypatch, bits, g, k, stacked,
                                      transpose):
    """The reference's route is observed by making it believe it runs on a
    TPU and recording whether it reaches its Pallas entry point; the port's
    by recording whether it reaches K5's wrapper.  Where both take the
    dequantize route, the values agree to f32 rounding."""
    rng = np.random.default_rng(bits + g + k)
    w = rng.standard_normal((3, 48, k) if stacked else (48, k)).astype(
        np.float32)
    ref_t = jq.quantize(jnp.asarray(w), bits=bits, group_size=g)
    t = tq.quantize(torch.from_numpy(w), bits=bits, group_size=g)
    x = rng.standard_normal((5, 48 if not transpose else k)).astype(
        np.float32)
    if not transpose and stacked:
        pytest.skip("a stacked weight is only multiplied transposed")
    seen = {}

    def ref_pallas(x, t, **kw):
        seen["ref"] = True
        return jnp.zeros(x.shape[:-1] + (t.q.shape[0],), x.dtype)

    def port_kernel(x, t):
        seen["port"] = True
        return x.new_zeros(x.shape[:-1] + (t.q.shape[0],))

    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(jqmm, "quantized_matmul_pallas", ref_pallas)
        mp.setattr(k5, "quantized_matmul_kernel", port_kernel)
        mp.delenv("MLX_VLM_TPU_QMM", raising=False)
        jq.quantized_matmul(jnp.asarray(x), ref_t, transpose=transpose)
        tq.quantized_matmul(torch.from_numpy(x), t, transpose=transpose)
    assert seen.get("port", False) == seen.get("ref", False)
    assert tq.qmm_kernel_route(t, transpose) == seen.get("ref", False)
    if not seen:
        ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), ref_t,
                                             transpose=transpose))
        got = tq.quantized_matmul(torch.from_numpy(x), t,
                                  transpose=transpose).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_cpu_calls_leave_k5_counters_at_zero():
    q, s, b = mlx_weight(4, 64, seed=1)
    _, t = both(q, s, b, 4, 64)
    before = dict(k5.launches)
    k5.quantized_matmul_kernel(torch.ones((2, K)), t)
    assert k5.launches == before == {"qmatmul_int4": 0, "qmatmul_int8": 0}


def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take():
    """The checks that guard the launch run before any CUDA call, so they
    are exercised here with CPU tensors passed to the check itself."""
    q, s, b = mlx_weight(4, 64, seed=2)
    _, t = both(q, s, b, 4, 64)
    with pytest.raises(TypeError, match="CUDA"):
        k5._check(torch.ones((1, K), dtype=torch.bfloat16), t)


# ----------------------------------------------------------- on a GPU only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 5, 70])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_k5_matches_plain(cuda_device, bits, g, M):
    """K5 against its plain version on the card with ragged edges (N = 1000
    output rows, M = 70 rows); tolerance 1e-2 * max|ref|: both round once to
    bf16 (one ulp is 2**-7 * max|ref| at most), and the kernel's factored
    group sums differ from the f32 dequantize only by reassociation."""
    q, s, b = mlx_weight(bits, g, seed=bits + g + M, n=1000, k=1024,
                         bf16=True)
    _, t = both(q, s, b, bits, g)
    t = tq.QuantizedTensor(q=t.q.to(cuda_device), scales=t.scales.to(cuda_device),
                           biases=t.biases.to(cuda_device), bits=bits,
                           group_size=g, out_dtype="bfloat16")
    x = _torch(_x((M, 1024), "bfloat16", seed=M)).to(cuda_device)
    name = f"qmatmul_int{bits}"
    n0 = k5.launches[name]
    got = k5.quantized_matmul_kernel(x, t)
    ref = k5.qmatmul_plain(x, t)
    torch.cuda.synchronize()
    assert k5.launches[name] == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, 1000)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())


# chip_smoke.py phase 2's K5 cases (group size, M, K, N): Qwen2-VL-7B's
# linears at M = 1 and 512, the lm_head, and groups 32 / 128
SHAPES_7B = ([(64, M, K, N) for M in (1, 512)
              for K, N in ((3584, 3584), (3584, 512), (3584, 18944),
                           (18944, 3584))]
             + [(64, 1, 3584, 152064), (32, 512, 3584, 3584),
                (128, 512, 3584, 3584)])


@pytest.mark.cuda
@pytest.mark.parametrize("g,M,K,N", SHAPES_7B)
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_k5_matches_plain_at_7b_shapes(cuda_device, bits, g, M, K, N):
    """K5 against its plain version at the 7B shapes, weights drawn on the
    card as an mlx checkpoint holds them (dequantized std 0.02); the same
    tolerance as above, for the same reason."""
    gen = torch.Generator(device=cuda_device).manual_seed(bits + g + M + N)
    s = 0.02 / np.sqrt((4**bits - 1) / 12.0) * (
        0.75 + 0.5 * torch.rand((N, K // g), generator=gen,
                                device=cuda_device))
    t = tq.QuantizedTensor(
        q=torch.randint(0, 256, (N, K * bits // 8), generator=gen,
                        device=cuda_device, dtype=torch.uint8),
        scales=s.to(torch.bfloat16),
        biases=(-(2**bits - 1) / 2 * s).to(torch.bfloat16), bits=bits,
        group_size=g, out_dtype="bfloat16")
    x = torch.randn((M, K), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    got = k5.quantized_matmul_kernel(x, t)
    ref = k5.qmatmul_plain(x, t)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())
