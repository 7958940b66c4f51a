"""Port parity: K5 takes every weight that the reference's route sends it.

An 8-bit weight whose K is a whole number of groups, an odd number of them
(Qwen2-VL-72B's down_proj: K = 29568, g = 128, 231 groups), passes the
reference's route rule (`qmm_kernel_route`).  K5's GEMV (up to 8 rows of
x) takes it: a row's scales and biases are copied as 32-bit words of the
array from the word that holds the chunk's first group of that row, one
group early where that group is a word's high half (csrc/qmatmul.cu
`sb_first` / `issue_sb`).  The tests hold the route and both plans to the
reference's rule, the value staging to the arrays it copies (a numpy
replay of the kernel's copies and reads), and the port's result at that
shape to the JAX package's `quantized_matmul`, the weight and x made with
numpy from a seed.  The 8-bit GEMM (more than 8 rows) at g = 32 takes K
an odd multiple of 32 too, by a trailing half stage; and the route sends
K5 only the group sizes it takes (32, 64, 128), the others to the
dequantize route, whose values match K5's plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlx_vlm_tpu.core import quant as jq
from mlx_vlm_tpu_torch.core import quant as tq
from mlx_vlm_tpu_torch.ops import qmatmul as k5

torch.set_num_threads(2)

K72, G72, N72 = 29568, 128, 64  # 72B's down_proj K and group; 64 rows of W


def _weight(bits, g, k, n, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (n, k * bits // 8), dtype=np.uint8)
    s = rng.uniform(0.01, 0.03, (n, k // g)).astype(np.float32)
    b = (-((2**bits - 1) / 2) * s
         + rng.normal(0, 1e-3, s.shape)).astype(np.float32)
    ref = jq.QuantizedTensor(q=jnp.asarray(q), scales=jnp.asarray(s),
                             biases=jnp.asarray(b), bits=bits, group_size=g,
                             out_dtype="float32")
    got = tq.QuantizedTensor(q=torch.from_numpy(q), scales=torch.from_numpy(s),
                             biases=torch.from_numpy(b), bits=bits,
                             group_size=g, out_dtype="float32")
    return ref, got


def _plan(rows, k, n, bits, g):
    """The plan of the K5 route that x's rows take."""
    if rows <= k5.MAX_GEMV_ROWS:
        return k5.qmatmul_gemv_plan(rows, k, n, bits, g)
    return k5.qmatmul_plan(rows, k, n, g, bits)


@pytest.mark.parametrize("rows", [1, 8, 9, 58])
def test_72b_down_proj_route_and_values(rows):
    ref_t, t = _weight(8, G72, K72, N72)
    assert tq.qmm_kernel_route(t)  # the reference's rule
    _plan(rows, K72, 8192, 8, G72)  # the kernel's plan takes it
    x = np.random.default_rng(rows).standard_normal((rows, K72)).astype(
        np.float32)
    want = np.asarray(jq.quantized_matmul(jnp.asarray(x), ref_t))
    scale = 1e-5 * max(1.0, float(np.abs(want).max()))
    xt = torch.from_numpy(x)
    for got in (k5.qmatmul_plain(xt, t), tq.quantized_matmul(xt, t)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=scale)


# (bits, g, K): shapes about the limits of each route of K5
LIMIT_CASES = [(4, 64, 128), (4, 64, 192), (4, 128, 29568), (8, 32, 96),
               (8, 64, 192), (8, 128, 384), (8, 128, 29568), (8, 16, 64),
               (4, 16, 64)]


@pytest.mark.parametrize("bits,g,k", LIMIT_CASES)
@pytest.mark.parametrize("rows", [1, 8, 64])
def test_plans_take_what_the_route_sends(bits, g, k, rows):
    """Every weight that the rule sends to K5 is taken by the plan of the
    route that x's rows take: the 8-bit GEMM at g = 32 and K an odd
    multiple of 32 too (its half stage).  A weight the rule keeps off K5
    (not whole groups, or a group size K5 does not take, whose plans
    raise) never reaches a plan."""
    _, t = _weight(bits, g, k, 4)
    if not tq.qmm_kernel_route(t):
        assert k % (2 * g if bits == 4 else g) or g not in k5.GROUP_SIZES
        if g not in k5.GROUP_SIZES:
            with pytest.raises(ValueError):
                _plan(rows, k, 256, bits, g)
        return
    _plan(rows, k, 256, bits, g)


@pytest.mark.parametrize("rows", [1, 9])
@pytest.mark.parametrize("bits", [4, 8])
def test_route_takes_k5_group_sizes(bits, rows):
    """A group of 16 passes the reference's rule (whole groups a row) but
    not K5's group sizes: the port's route sends it to the dequantize
    route, whose values match K5's plain version and the JAX package's
    quantized_matmul (its XLA route on the CPU), to f32 rounding."""
    ref_t, t = _weight(bits, 16, 128, 48)
    assert t.q.shape[1] % 16 == 0 and not tq.qmm_kernel_route(t)
    x = np.random.default_rng(bits + rows).standard_normal(
        (rows, 128)).astype(np.float32)
    want = np.asarray(jq.quantized_matmul(jnp.asarray(x), ref_t))
    xt = torch.from_numpy(x)
    before = dict(k5.launches)
    got = tq.quantized_matmul(xt, t).numpy()
    assert k5.launches == before
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got, k5.qmatmul_plain(xt, t).numpy(), rtol=0,
                               atol=atol)


def _staged_values(arr, M, K, N, bits, g):
    """A numpy replay of the GEMV's value staging (csrc/qmatmul.cu
    `issue_sb`, `sb_first` and the reads of `consume` / `fold`) for the
    scales or biases `arr` [N, K / g] at x [M, K]: for every tile, chunk,
    row and group of the chunk, the value that the fold reads.  Copies are
    32-bit words of the flattened array (a word never straddles its end:
    the array's last value alone is a plain copy).  Returns the values read
    [N, K / g] and the shared-memory row width used at most."""
    rt, chunks = k5.qmatmul_gemv_plan(M, K, N, bits, g)
    ng = K // g
    flat = arr.reshape(-1)
    total = flat.size
    gb = g * bits // 8
    unit = max(gb, k5.GEMV_STEP)
    gpu = max(k5.GEMV_STEP // gb, 1) if gb <= k5.GEMV_STEP else 1
    units = K * bits // 8 // unit
    kc = -(-units // chunks) * unit * 8 // bits
    sbw = ng if chunks == 1 else (kc // g + 2) // 2 * 2
    rows_t = 16 * rt
    got = np.full(arr.shape, np.nan, arr.dtype)
    widest = 0
    for nb0 in range(0, N, rows_t):
        nrows = min(rows_t, N - nb0)
        if chunks == 1:  # whole rows, one span of nrows * ng values
            shared = flat[nb0 * ng:(nb0 + nrows) * ng].copy()
            for r in range(nrows):
                got[nb0 + r] = shared[r * sbw:r * sbw + ng]
            widest = max(widest, ng)
            continue
        for c in range(chunks):
            cu0 = c * units // chunks
            cn = (c + 1) * units // chunks - cu0
            cg0, n_g = cu0 * gpu, cn * gpu
            shared = np.full((nrows, sbw), np.nan, arr.dtype)
            for r in range(nrows):
                e0 = cg0 - (((r & ng) + cg0) & 1)  # sb_first
                for w in range((cg0 + n_g - e0 + 1) >> 1):
                    e = (nb0 + r) * ng + e0 + 2 * w
                    assert e % 2 == 0  # a 4-byte aligned word
                    n_copy = 2 if e + 1 < total else 1
                    shared[r, 2 * w:2 * w + n_copy] = flat[e:e + n_copy]
                    widest = max(widest, 2 * w + 2)
                # the fold: group gg of row r at r * sbw + gg - e0, e0 from
                # the thread's row (rows g8 and g8 + 8 of a 16-row tile have
                # the same parity)
                for gg in range(cg0, cg0 + n_g):
                    got[nb0 + r, gg] = shared[r, gg - e0]
    return got, widest, sbw


# (M, K, N) at 8 bits, g = 128: 231 groups (72B's down_proj, 2 / 4 / 8
# chunks that start at odd groups) and 29 (one chunk), N even and odd
STAGING_CASES = [(1, K72, 64), (4, K72, 48), (8, K72, 33), (5, K72, 17),
                 (1, 3712, 1001), (1, 3712, 18945), (8, 3712, 35)]


@pytest.mark.parametrize("M,K,N", STAGING_CASES)
def test_gemv_stages_every_value_at_odd_group_counts(M, K, N):
    bits, g = 8, 128
    arr = np.arange(N * (K // g), dtype=np.float64).reshape(N, K // g)
    got, widest, sbw = _staged_values(arr, M, K, N, bits, g)
    assert widest <= sbw
    np.testing.assert_array_equal(got, arr)


def test_gemv_plan_at_72b_down_proj():
    """The 72B down_proj (N = 8192) at 1 to 8 rows of x: K splits into
    chunks whose x fits the GEMV's shared memory."""
    for M in range(1, k5.MAX_GEMV_ROWS + 1):
        rt, chunks = k5.qmatmul_gemv_plan(M, K72, 8192, 8, G72)
        assert k5._gemv_smem(M, K72, 8192, 8, G72, rt, chunks) <= \
            k5.GEMV_SMEM_BYTES
        assert chunks > 1
