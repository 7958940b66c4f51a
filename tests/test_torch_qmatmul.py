"""Port parity: K5, the mlx group-affine linear (ops/qmatmul.py).

The port's plain version is held to the reference's Pallas kernel run in
interpret mode (as tests/test_qmatmul.py runs it), for 4- and 8-bit codes,
group sizes 32 / 64 / 128, 1 to 70 rows, leading dims, and x in float32 and
bfloat16.  The port's route rule is held to the reference's, and the
dequantize route to the reference's `quantized_matmul` on the CPU.  The
int4 GEMM route's fold (codes as bf16 128 + q, per-group f32 partials,
s P + (b - 128 s) sum x, split-K slices added in order) is emulated in
plain PyTorch and held to the Pallas kernel too, and so is the GEMV
route's (codes as exact bf16 operands, two partial chains per step, the
fold per group, K parts per warp and per chunk added in order); both
plans and the wrapper's refusals are checked on CPU tensors.  Inputs are
made with numpy from a seed and handed to both packages.  Tests marked
`cuda` hold the CUDA kernels to their plain version on a GPU and skip
without one.
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


def test_cuda_wrapper_refusals_before_any_launch():
    """The int4 GEMM route refuses non-bf16 x, K not a whole number of group
    pairs and misaligned arrays before it reaches the kernel library (the
    shape and layout checks hold on any device, so CPU tensors show them)."""
    q, s, b = mlx_weight(4, 64, seed=3, bf16=True)
    _, t = both(q, s, b, 4, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        k5._check_args(torch.ones((16, K)), t)
    x = torch.ones((16, K), dtype=torch.bfloat16)
    k5._check_args(x, t)  # the well-formed case passes
    q6, s6, b6 = mlx_weight(4, 64, seed=3, k=192, bf16=True)
    _, t6 = both(q6, s6, b6, 4, 64)
    with pytest.raises(ValueError, match="group pairs"):
        k5._check_args(torch.ones((16, 192), dtype=torch.bfloat16), t6)
    with pytest.raises(ValueError, match="not taken"):
        k5.qmatmul_plan(16, 192, N, 64)
    buf = torch.empty(16 * K + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k5._int4_gemm(buf[1:].view(16, K), t, K, N)
    qbuf = torch.empty(t.q.numel() + 1, dtype=torch.uint8)
    qbuf[1:] = t.q.reshape(-1)
    moved = tq.QuantizedTensor(q=qbuf[1:].view(t.q.shape), scales=t.scales,
                               biases=t.biases, bits=4, group_size=64,
                               out_dtype="bfloat16")
    with pytest.raises(ValueError, match="16-byte aligned"):
        k5._check_args(x, moved)


# The shapes the main path and chip_smoke.py give the int4 GEMM route
# (Qwen2-VL-7B's linears) at the row counts of prefill chunks
PLAN_SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("K,N", PLAN_SHAPES + ((3584, 1000), (1024, 130)))
@pytest.mark.parametrize("M", [9, 70, 100, 300, 512])
def test_qmatmul_plan(M, K, N, g):
    """The row tile is one the kernel instantiates; K slices are whole
    units of max(g, 64) codes (whole groups and whole 64-code stages); a
    split grid fills the 132 SMs as far as the units allow and never
    exceeds them."""
    bm, splits = k5.qmatmul_plan(M, K, N, g)
    assert bm in (64, 128)
    unit = max(g, 64)
    assert unit % g == 0 and K % unit == 0
    units = K // unit
    assert 1 <= splits <= units
    tiles = -(-M // bm) * -(-N // 128)
    if splits > 1:
        assert tiles * splits <= k5.SMS
        assert tiles * (splits + 1) > k5.SMS or splits == units
    else:
        assert tiles * 2 > k5.SMS or units == 1


def test_qmatmul_plan_at_7b_shapes():
    """The plans of a 512-row chunk: the narrow k/v projections split K
    over 8 slices (128 blocks); the others fill the card with tiles."""
    assert k5.qmatmul_plan(512, 3584, 512, 64) == (128, 8)
    assert k5.qmatmul_plan(512, 3584, 3584, 64) == (128, 1)
    assert k5.qmatmul_plan(512, 3584, 18944, 64) == (128, 1)
    assert k5.qmatmul_plan(512, 18944, 3584, 64) == (128, 1)
    assert k5.qmatmul_plan(100, 3584, 1000, 64) == (64, 8)
    for M in (1, 8):
        with pytest.raises(ValueError, match="GEMV"):
            k5.qmatmul_plan(M, 3584, 3584, 64)


def fold_emulation(x, t, splits=1):
    """The int4 GEMM route's arithmetic in plain PyTorch: codes as bf16
    128 + q (exact), per-group f32 partials P = sum x (128 + q) and sums of
    x, each group folded as acc += s P + (b - 128 s) sum x in f32; K split
    into `splits` slices of whole max(g, 64)-code units whose f32 partials
    are added in slice order; one rounding to bf16."""
    g = t.group_size
    n, kb = t.q.shape
    k = 2 * kb
    codes = torch.stack([t.q & 0xF, t.q >> 4], dim=-1).reshape(n, k)
    c128 = (128 + codes.float()).to(torch.bfloat16).float()
    xf = x.float()
    s, b = t.scales.float(), t.biases.float()
    units = k // max(g, 64)
    total = None
    for z in range(splits):
        k0 = z * units // splits * max(g, 64)
        k1 = (z + 1) * units // splits * max(g, 64)
        acc = torch.zeros((x.shape[0], n))
        for j in range(k0 // g, k1 // g):
            sl = slice(j * g, (j + 1) * g)
            P = xf[:, sl] @ c128[:, sl].T
            sx = xf[:, sl].sum(dim=1, keepdim=True)
            acc = acc + s[:, j] * P + (b[:, j] - 128 * s[:, j]) * sx
        total = acc if total is None else total + acc
    return total.to(torch.bfloat16)


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("M", [9, 70, 100])
@pytest.mark.parametrize("g", [32, 64, 128])
def test_int4_fold_emulation_matches_pallas(g, M, splits):
    """The design's numerics before the chip: the fold emulation against
    the reference's _qmm4_kernel in interpret mode, bf16 x and weights as
    on the card, within K5_TOL = 1e-2 * max|ref| (both round once to bf16;
    the sums differ by f32 reassociation only)."""
    q, s, b = mlx_weight(4, g, seed=4000 + g + M, bf16=True)
    ref_t, t = both(q, s, b, 4, g)
    x = _x((M, K), "bfloat16", seed=7 * M + g)
    ref = np.asarray(jqmm.quantized_matmul_pallas(jnp.asarray(x), ref_t,
                                                  interpret=True))
    got = fold_emulation(_torch(x), t, splits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=1e-2 * float(np.abs(ref).max()))


def gemv_emulation(x, t, rt=1, chunks=1):
    """The GEMV route's arithmetic (csrc/qmatmul.cu, qmv_kernel) in plain
    PyTorch.  Codes are the exact bf16 operands the kernel builds: 128 + q
    at 4 bits; at 8 bits (128 + low nibble) and (256 + 16 high nibble), two
    MMAs into one partial, so x (384 + q).  Each 32-byte step of a row is
    two 16-byte pieces, each summed into a partial of its own (at 4 bits
    and g = 32 a piece is a group); a group's partial P, its pieces added,
    is folded as acc += s P + (b - off s) sum x in f32.  K is cut into
    units of max(group bytes, 32) bytes, the units into `chunks` chunks and
    each chunk into 8 / rt warp parts; each part's acc runs over the
    chunks, and the parts are added in order; one rounding to bf16."""
    g, bits = t.group_size, t.bits
    n, rb = t.q.shape
    k = rb * 8 // bits
    if bits == 4:
        codes = torch.stack([t.q & 0xF, t.q >> 4], dim=-1).reshape(n, k)
        val = (128 + codes.float()).to(torch.bfloat16).float()
        off = 128.0
    else:
        lo = (128 + (t.q & 0xF).float()).to(torch.bfloat16).float()
        hi = (256 + 16 * (t.q >> 4).float()).to(torch.bfloat16).float()
        val, off = lo + hi, 384.0
    piece = (torch.arange(k) * bits // 8) % 32 // 16  # the piece of each k
    xf = x.float()
    s, b = t.scales.float(), t.biases.float()
    unit = max(g * bits // 8, 32) * 8 // bits  # codes
    units, parts = k // unit, 8 // rt
    acc = [torch.zeros((x.shape[0], n)) for _ in range(parts)]
    for c in range(chunks):
        cu0, cu1 = c * units // chunks, (c + 1) * units // chunks
        for w in range(parts):
            u0 = cu0 + w * (cu1 - cu0) // parts
            u1 = cu0 + (w + 1) * (cu1 - cu0) // parts
            for j in range(u0 * unit // g, u1 * unit // g):
                ks = torch.arange(j * g, (j + 1) * g)
                P = 0.0
                for p in (0, 1):
                    kp = ks[piece[ks] == p]
                    if len(kp):
                        P = P + xf[:, kp] @ val[:, kp].T
                sx = xf[:, ks].sum(dim=1, keepdim=True)
                acc[w] = acc[w] + s[:, j] * P + (b[:, j] - off * s[:, j]) * sx
    total = acc[0]
    for a in acc[1:]:
        total = total + a
    return total.to(torch.bfloat16)


@pytest.mark.parametrize("layout", [(1, 1), (2, 2)])
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_gemv_emulation_matches_pallas(bits, g, M, layout):
    """The GEMV design's numerics before the chip: its emulation, with one
    or two row tiles a block and one or two chunks of K, against the
    reference's kernel in interpret mode, bf16 x and weights as on the
    card, within K5_TOL = 1e-2 * max|ref| (both round once to bf16; the
    sums differ by f32 reassociation only)."""
    q, s, b = mlx_weight(bits, g, seed=6000 + 10 * g + M + bits, bf16=True)
    ref_t, t = both(q, s, b, bits, g)
    x = _x((M, K), "bfloat16", seed=11 * M + g + bits)
    ref = np.asarray(jqmm.quantized_matmul_pallas(jnp.asarray(x), ref_t,
                                                  interpret=True))
    got = gemv_emulation(_torch(x), t, *layout)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=1e-2 * float(np.abs(ref).max()))


# Qwen2-VL-7B's linears and head (K, N) and ragged widths, for the GEMV plan
GEMV_SHAPES = PLAN_SHAPES + ((3584, 152064), (3584, 1000), (1024, 130),
                             (1280, 3840))


@pytest.mark.parametrize("bits,g", [(4, 32), (4, 64), (4, 128), (8, 32),
                                    (8, 64), (8, 128)])
@pytest.mark.parametrize("K,N", GEMV_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 5, 8])
def test_qmatmul_gemv_plan(M, K, N, bits, g):
    """The row tiles are the largest of 8, 4, 2 that still give
    GEMV_MIN_BLOCKS blocks of at most GEMV_BLOCK_CODES code bytes (fewer
    blocks and twice the bytes from GEMV_BIG_ROWS rows of x on), else 1;
    the chunks are the least power of two (at most the K
    units) that keeps a block's shared memory within GEMV_SMEM_BYTES, and
    that fits: two blocks share an SM."""
    rt, chunks = k5.qmatmul_gemv_plan(M, K, N, bits, g)
    assert rt in (1, 2, 4, 8) and chunks >= 1 and chunks & (chunks - 1) == 0
    big = M >= k5.GEMV_BIG_ROWS
    need = k5.GEMV_MIN_BLOCKS[big]
    cap = k5.GEMV_BLOCK_CODES * (2 if big else 1)

    def fits(r):
        return -(-N // (16 * r)) >= need and 16 * r * K * bits // 8 <= cap

    assert rt == 1 or fits(rt)
    assert not any(fits(r) for r in (8, 4, 2) if r > rt)
    units = K * bits // 8 // max(g * bits // 8, 32)
    assert chunks <= units
    smem = k5._gemv_smem(M, K, N, bits, g, rt, chunks)
    assert smem <= k5.GEMV_SMEM_BYTES
    if chunks > 1:
        assert k5._gemv_smem(M, K, N, bits, g, rt, chunks // 2) > \
            k5.GEMV_SMEM_BYTES
    assert 2 * (smem + 4096 + 1024) <= 228 * 1024  # + red[], + reserved


def test_qmatmul_gemv_plan_at_7b_shapes():
    """A decode step's plans: two row tiles a block for the q/o
    projections, one (with K split over the block's 8 warps) for k/v and
    down_proj; 4 row tiles (2 at 8 bits, whose rows are twice as long) for
    gate/up and the head, whose grids are persistent; 8 for gate/up at
    M = 8; x staged in chunks only where M rows of a whole K do not fit."""
    plan = k5.qmatmul_gemv_plan
    assert plan(1, 3584, 3584, 4, 64) == (2, 1)
    assert plan(1, 3584, 512, 4, 64) == (1, 1)
    assert plan(1, 3584, 18944, 4, 64) == (4, 1)
    assert plan(1, 3584, 18944, 8, 64) == (2, 1)
    assert plan(1, 18944, 3584, 4, 64) == (1, 1)
    assert plan(1, 3584, 152064, 4, 64) == (4, 1)
    assert plan(8, 3584, 18944, 4, 64) == (8, 2)
    assert plan(8, 3584, 3584, 8, 64) == (2, 1)
    assert plan(8, 18944, 3584, 4, 64) == (1, 8)
    for bits, rt in ((4, 4), (8, 2)):
        assert k5._gemv_persistent(3584, 18944, bits, 64, rt, 1)
        assert k5._gemv_persistent(3584, 152064, bits, 64, rt, 1)
    assert not k5._gemv_persistent(3584, 3584, 4, 64, 2, 1)


def test_gemv_refusals_before_any_launch():
    """The GEMV takes 1 to 8 rows, K a whole number of group pairs at both
    widths (its scales and biases travel as 32-bit words) and 4-byte
    aligned scales and biases; it refuses anything else before it reaches
    the kernel library (CPU tensors show it)."""
    for M in (0, 9):
        with pytest.raises(ValueError, match="GEMV"):
            k5.qmatmul_gemv_plan(M, K, N, 4, 64)
    with pytest.raises(ValueError, match="group pairs"):
        k5.qmatmul_gemv_plan(1, 96, N, 8, 32)
    k5.qmatmul_gemv_plan(1, 64, N, 8, 32)  # two groups: taken
    q, s, b = mlx_weight(8, 32, seed=5, bf16=True)
    _, t = both(q, s, b, 8, 32)
    buf = torch.empty(t.scales.numel() + 1, dtype=torch.bfloat16)
    buf[1:] = t.scales.reshape(-1)
    moved = tq.QuantizedTensor(q=t.q, scales=buf[1:].view(t.scales.shape),
                               biases=t.biases, bits=8, group_size=32,
                               out_dtype="bfloat16")
    with pytest.raises(ValueError, match="4-byte"):
        k5._gemv(torch.ones((1, K), dtype=torch.bfloat16), moved, K, N)


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


@pytest.mark.cuda
@pytest.mark.parametrize("M", [9, 70, 512])
@pytest.mark.parametrize("g", [32, 64, 128])
def test_cuda_k5_int4_gemm(cuda_device, g, M):
    """The int4 GEMM route at ragged N (1000) against the plain version
    (1e-2 * max|ref|, as above) and the fold emulation, one counted call,
    and a repeated call bit-identical (the split-K slices are added in a
    fixed order)."""
    q, s, b = mlx_weight(4, g, seed=50 + g + M, n=1000, k=1024, bf16=True)
    _, t = both(q, s, b, 4, g)
    t = tq.QuantizedTensor(q=t.q.to(cuda_device), scales=t.scales.to(cuda_device),
                           biases=t.biases.to(cuda_device), bits=4,
                           group_size=g, out_dtype="bfloat16")
    x = _torch(_x((M, 1024), "bfloat16", seed=M)).to(cuda_device)
    n0 = k5.launches["qmatmul_int4"]
    got = k5.quantized_matmul_kernel(x, t)
    again = k5.quantized_matmul_kernel(x, t)
    ref = k5.qmatmul_plain(x, t)
    torch.cuda.synchronize()
    assert k5.launches["qmatmul_int4"] == n0 + 2
    assert torch.equal(got, again)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())
    _, splits = k5.qmatmul_plan(M, 1024, 1000, g)
    emu = fold_emulation(x.cpu(), tq.QuantizedTensor(
        q=t.q.cpu(), scales=t.scales.cpu(), biases=t.biases.cpu(), bits=4,
        group_size=g, out_dtype="bfloat16"), splits)
    err = float((got.cpu().float() - emu.float()).abs().max())
    assert err <= 1e-2 * float(emu.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_k5_gemv(cuda_device, bits, g, M):
    """The GEMV route at ragged N (1000) against the plain version (1e-2 *
    max|ref|, as above) and its emulation, one counted launch per call,
    and a repeated call bit-identical (the warps' K parts are added in a
    fixed order)."""
    q, s, b = mlx_weight(bits, g, seed=70 + g + M + bits, n=1000, k=1024,
                         bf16=True)
    _, t = both(q, s, b, bits, g)
    t = tq.QuantizedTensor(q=t.q.to(cuda_device), scales=t.scales.to(cuda_device),
                           biases=t.biases.to(cuda_device), bits=bits,
                           group_size=g, out_dtype="bfloat16")
    x = _torch(_x((M, 1024), "bfloat16", seed=M + bits)).to(cuda_device)
    name = f"qmatmul_int{bits}"
    n0 = k5.launches[name]
    got = k5.quantized_matmul_kernel(x, t)
    again = k5.quantized_matmul_kernel(x, t)
    ref = k5.qmatmul_plain(x, t)
    torch.cuda.synchronize()
    assert k5.launches[name] == n0 + 2
    assert torch.equal(got, again)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())
    rt, chunks = k5.qmatmul_gemv_plan(M, 1024, 1000, bits, g)
    emu = gemv_emulation(x.cpu(), tq.QuantizedTensor(
        q=t.q.cpu(), scales=t.scales.cpu(), biases=t.biases.cpu(), bits=bits,
        group_size=g, out_dtype="bfloat16"), rt, chunks)
    err = float((got.cpu().float() - emu.float()).abs().max())
    assert err <= 1e-2 * float(emu.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_k5_gemv_persistent(cuda_device, bits, M):
    """A weight with more row tiles than two blocks an SM (Qwen2-VL-7B's
    gate/up projection, N = 18944) takes the persistent grid: blocks walk
    tiles, fetching the next tile's scales and codes while they finish
    one.  Against the plain version (1e-2 * max|ref|), bit-identical on a
    repeat."""
    Kp, Np, g = 3584, 18944, 64
    rt, chunks = k5.qmatmul_gemv_plan(M, Kp, Np, bits, g)
    assert k5._gemv_persistent(Kp, Np, bits, g, rt, chunks)
    q, s, b = mlx_weight(bits, g, seed=90 + bits + M, n=Np, k=Kp, bf16=True)
    _, t = both(q, s, b, bits, g)
    t = tq.QuantizedTensor(q=t.q.to(cuda_device), scales=t.scales.to(cuda_device),
                           biases=t.biases.to(cuda_device), bits=bits,
                           group_size=g, out_dtype="bfloat16")
    x = _torch(_x((M, Kp), "bfloat16", seed=M)).to(cuda_device)
    got = k5.quantized_matmul_kernel(x, t)
    again = k5.quantized_matmul_kernel(x, t)
    ref = k5.qmatmul_plain(x, t)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())


@pytest.mark.cuda
def test_cuda_k5_int4_gemm_split_is_repeatable(cuda_device):
    """A 512-row chunk on a narrow weight splits K (8 slices at g = 32) and
    gives the same bits on every call."""
    M, Kb, Nb, g = 512, 3584, 512, 32
    assert k5.qmatmul_plan(M, Kb, Nb, g)[1] > 1
    q, s, b = mlx_weight(4, g, seed=9, n=Nb, k=Kb, bf16=True)
    _, t = both(q, s, b, 4, g)
    t = tq.QuantizedTensor(q=t.q.to(cuda_device), scales=t.scales.to(cuda_device),
                           biases=t.biases.to(cuda_device), bits=4,
                           group_size=g, out_dtype="bfloat16")
    x = _torch(_x((M, Kb), "bfloat16", seed=3)).to(cuda_device)
    first = k5.quantized_matmul_kernel(x, t)
    for _ in range(3):
        assert torch.equal(k5.quantized_matmul_kernel(x, t), first)
    ref = k5.qmatmul_plain(x, t)
    torch.cuda.synchronize()
    err = float((first.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())
