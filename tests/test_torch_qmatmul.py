"""Port parity: K5, the mlx group-affine linear (ops/qmatmul.py).

The port's plain version is held to the reference's Pallas kernel run in
interpret mode (as tests/test_qmatmul.py runs it), for 4- and 8-bit codes,
group sizes 32 / 64 / 128, 1 to 70 rows, leading dims, and x in float32 and
bfloat16.  The port's route rule is held to the reference's, and the
dequantize route to the reference's `quantized_matmul` on the CPU.  The
GEMM route's fold at both widths (codes as bf16 128 + q, or at 8 bits as
two exact parts 128 + low nibble and 256 + 16 high nibble into one
partial; per-group f32 partials, s P + (b - c s) sum x, split-K slices
added in order) is emulated in plain PyTorch and held to the Pallas
kernels too, and so is the GEMV route's (codes as exact bf16 operands,
two partial chains per step, the fold per group, K parts per warp and per
chunk added in order).  The 8-bit GEMM's A fragments (their bit patterns
and their gather from the swizzled code box) are replayed in numpy
against the wgmma fragment layout; both plans, their mirror of the
kernel's layout constants and the wrapper's refusals are checked on CPU
tensors.  Inputs are
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
    stack = tq.QuantizedTensor(q=t.q[None], scales=t.scales[None],
                               biases=t.biases[None], bits=4, group_size=64,
                               out_dtype=t.out_dtype)
    k5.quantized_matmul_experts(torch.ones((2, K)), stack,
                                torch.zeros(3, dtype=torch.int32),
                                torch.tensor([0, 1, 1], dtype=torch.int32))
    assert k5.launches == before == {"qmatmul_int4": 0, "qmatmul_int8": 0,
                                     "qmatmul_experts": 0}


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
        k5._gemm(buf[1:].view(16, K), t, K, N)
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


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("K,N", PLAN_SHAPES)
@pytest.mark.parametrize("M", [58, 512])
def test_qmatmul_plan_8bit(M, K, N, g):
    """The 8-bit GEMM's plans at an 8-bit model's prefill chunks (a 58-row
    chunk and a 512-row one) over Qwen2-VL-7B's seven linears (q/o, k/v,
    gate/up, down): a row tile the kernel instantiates, K slices of whole
    max(g, 64)-code units, a split grid within the 132 SMs or, past one
    wave at a row tile of 64, two slices where their half waves are fewer
    than twice the full ones (148 tiles at N = 18944: 3 half waves against
    2 full), and the block's ring within the 227 KB an H100 block may take
    beside the kernel's barrier arrays."""
    bm, splits = k5.qmatmul_plan(M, K, N, g, bits=8)
    assert bm in (64, 128)
    unit = max(g, 64)
    assert K % unit == 0
    assert 1 <= splits <= K // unit
    tiles = -(-M // bm) * -(-N // 128)
    waves = -(-tiles // k5.SMS)
    if tiles > k5.SMS:
        halves = -(-2 * tiles // k5.SMS)
        want = 2 if bm == 64 and halves < 2 * waves else 1
        assert splits == want
    else:
        assert tiles * splits <= k5.SMS
    assert k5._gemm_smem(8, bm) + 3 * 12 * 8 <= k5.SMEM_PER_BLOCK


def test_qmatmul_plan_8bit_at_7b_shapes():
    """A 58-row chunk (the 8-bit smoke request's prompt) splits K over 4
    slices at 3584^2 and K = 18944 (112 blocks) and 33 at N = 512 (132
    blocks); gate/up's 148 tiles split K in two (296 blocks in three half
    waves).  At 512 rows the plans are the 4-bit ones: K splits only at
    N = 512."""
    plan = k5.qmatmul_plan
    assert plan(58, 3584, 3584, 64, bits=8) == (64, 4)
    assert plan(58, 3584, 512, 64, bits=8) == (64, 33)
    assert plan(58, 3584, 18944, 64, bits=8) == (64, 2)
    assert plan(58, 3584, 18944, 64) == (64, 1)  # 4 bits: unchanged
    assert plan(58, 18944, 3584, 64, bits=8) == (64, 4)
    for K, N in PLAN_SHAPES:
        assert plan(512, K, N, 64, bits=8) == plan(512, K, N, 64)
    assert plan(512, 3584, 512, 64, bits=8) == (128, 8)
    assert plan(9, 64, 128, 32, bits=8) == (64, 1)  # one 64-code unit


def test_gemm_layout_mirrors_the_kernel():
    """ops/qmatmul.py's GEMM constants and _gemm_smem against
    csrc/qmatmul.cu's: QG_BK, QG_BN, QmmLayout's stages per width and row
    tile, its stage formula, and the kernel's own static check of the
    227 KB; every instance fits."""
    import re
    from pathlib import Path

    src = (Path(k5.__file__).parent.parent / "csrc/qmatmul.cu").read_text()
    consts = dict(re.findall(r"constexpr int (QG_\w+) = (\d+);", src))
    assert int(consts["QG_BK"]) == k5.GEMM_BK
    assert int(consts["QG_BN"]) == k5.GEMM_BN
    m = re.search(r"STAGES =\s+BITS == 4 \? \(BM == 64 \? (\d+) : (\d+)\) : "
                  r"\(BM == 64 \? (\d+) : (\d+)\);", src)
    assert m is not None
    assert tuple(map(int, m.groups())) == (
        k5.GEMM_STAGES[(4, 64)], k5.GEMM_STAGES[(4, 128)],
        k5.GEMM_STAGES[(8, 64)], k5.GEMM_STAGES[(8, 128)])
    for line in ("X_BYTES = BM * QG_BK * 2;",
                 "W_BYTES = QG_BN * QG_BK * BITS / 8;",
                 "SC_BYTES = 2 * QG_BN * 8;", "XS_BYTES = 2 * BM * 4;",
                 "META = (SC_BYTES + XS_BYTES + 1023) / 1024 * 1024;",
                 "STAGE = X_BYTES + W_BYTES + META;",
                 "SMEM = STAGES * STAGE + 1024;",
                 "SMEM + 3 * QG_MAX_STAGES * 8 <= 232448"):
        assert line in src, line
    barriers = 3 * int(consts["QG_MAX_STAGES"]) * 8
    for (bits, bm), stages in k5.GEMM_STAGES.items():
        assert stages <= int(consts["QG_MAX_STAGES"])
        assert k5._gemm_smem(bits, bm) + barriers <= k5.SMEM_PER_BLOCK
        # the 8-bit rings fill the 227 KB: one more stage would not fit
        stage = (k5._gemm_smem(bits, bm) - 1024) // stages
        assert bits == 4 or ((stages + 1) * stage + 1024 + barriers
                             > k5.SMEM_PER_BLOCK)
    assert k5._gemm_smem(8, 64) == 11 * 19456 + 1024
    assert k5._gemm_smem(8, 128) == 8 * 27648 + 1024


@pytest.mark.parametrize("bits", [4, 8])
def test_gemm_split_bounds_divide_exactly(bits):
    """The kernel finds its K slice [z U / S, (z + 1) U / S) with no
    integer division (whose code converts integers to floats): as
    div_magic, the high word of n * ceil(2^32 / S), exact while U S^2 <
    2^32, which mvt_qmatmul_gemm checks.  Held to floor division at every
    plan of the 7B shapes and the ragged ones, and at the widest K slices
    the 132 SMs allow."""
    cases = [(k5.qmatmul_plan(M, Kp, Np, g, bits)[1], Kp // max(g, 64))
             for M in (9, 58, 100, 512) for g in (32, 64, 128)
             for Kp, Np in PLAN_SHAPES + ((3584, 1000), (1024, 130))]
    cases += [(splits, units) for splits in (2, 33, 131, 132)
              for units in (splits, 296, 4096, 65536)]
    for splits, units in cases:
        assert units * splits * splits < 2**32
        m = -(-2**32 // splits) if splits > 1 else 0
        for z in range(splits + 1):
            n = z * units
            got = (n * m) >> 32 if m else n
            assert got == n // splits, (splits, units, z)


def test_int8_gemm_refusals_before_any_launch():
    """The 8-bit GEMM refuses non-bf16 x, K not a whole number of groups
    (K = 96 at g = 32 is three groups: the plan takes it, two 64-code
    stages, the second a half stage), x or q not 16-byte aligned and
    scales or biases not 4-byte aligned, before it reaches the kernel
    library (CPU tensors show it), and counts no launch."""
    before = dict(k5.launches)
    q, s, b = mlx_weight(8, 32, seed=12, bf16=True)
    _, t = both(q, s, b, 8, 32)
    x = torch.ones((16, K), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        k5._check_args(torch.ones((16, K)), t)
    q3, s3, b3 = mlx_weight(8, 32, seed=12, k=96, bf16=True)
    _, t3 = both(q3, s3, b3, 8, 32)
    x3 = torch.ones((16, 96), dtype=torch.bfloat16)
    k5._check_args(x3, t3)  # whole groups: the shape checks pass
    assert k5.qmatmul_plan(16, 96, N, 32, bits=8) == (64, 2)
    with pytest.raises(ValueError, match="32-code units"):
        k5.qmatmul_plan(16, 80, N, 32, bits=8)
    with pytest.raises(ValueError, match="128-code units"):
        k5.qmatmul_plan(16, 192, N, 128, bits=8)
    buf = torch.empty(16 * K + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k5._gemm(buf[1:].view(16, K), t, K, N)

    def moved(a):
        out = torch.empty(a.numel() + 1, dtype=a.dtype)
        out[1:] = a.reshape(-1)
        return out[1:].view(a.shape)

    for field in ("q", "scales", "biases"):
        arrays = {"q": t.q, "scales": t.scales, "biases": t.biases}
        arrays[field] = moved(arrays[field])
        bad = tq.QuantizedTensor(**arrays, bits=8, group_size=32,
                                 out_dtype="bfloat16")
        with pytest.raises(ValueError, match="byte aligned"):
            k5._gemm(x, bad, K, N)
    assert k5.launches == before


def fold_emulation(x, t, splits=1):
    """The GEMM route's arithmetic in plain PyTorch.  4-bit codes as bf16
    128 + q (exact); each 8-bit code as two exact bf16 parts, lo = 128 +
    (low nibble) and hi = 256 + 16 (high nibble), both multiplied into the
    same partial, so that it sums x (384 + q).  Per-group f32 partials P
    and sums of x, each group folded as acc += s P + (b - c s) sum x in
    f32 (c = 128 or 384); K split into `splits` slices of whole max(g,
    64)-code units whose f32 partials are added in slice order; one
    rounding to bf16."""
    g = t.group_size
    n, kb = t.q.shape
    if t.bits == 4:
        k, off = 2 * kb, 128.0
        codes = torch.stack([t.q & 0xF, t.q >> 4], dim=-1).reshape(n, k)
        parts = [(128 + codes.float()).to(torch.bfloat16).float()]
    else:
        k, off = kb, 384.0
        parts = [(128 + (t.q & 0xF).float()).to(torch.bfloat16).float(),
                 (256 + 16 * (t.q >> 4).float()).to(torch.bfloat16).float()]
    xf = x.float()
    s, b = t.scales.float(), t.biases.float()
    units = -(-k // max(g, 64))  # a trailing half stage counts as a unit
    total = None
    for z in range(splits):
        k0 = z * units // splits * max(g, 64)
        k1 = min((z + 1) * units // splits * max(g, 64), k)
        acc = torch.zeros((x.shape[0], n))
        for j in range(k0 // g, k1 // g):
            sl = slice(j * g, (j + 1) * g)
            P = xf[:, sl] @ parts[0][:, sl].T
            for part in parts[1:]:
                P = P + xf[:, sl] @ part[:, sl].T
            sx = xf[:, sl].sum(dim=1, keepdim=True)
            acc = acc + s[:, j] * P + (b[:, j] - off * s[:, j]) * sx
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


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("M", [9, 58, 100])
@pytest.mark.parametrize("g", [32, 64, 128])
def test_int8_fold_emulation_matches_pallas(g, M, splits):
    """The 8-bit GEMM's numerics before the chip: two exact parts into one
    partial, the fold with b - 384 s, split slices added in order, against
    the reference's _qmm8_kernel in interpret mode, bf16 x and weights as
    on the card, within K5_TOL = 1e-2 * max|ref| (both round once to bf16;
    the sums differ by f32 reassociation only)."""
    q, s, b = mlx_weight(8, g, seed=8000 + g + M, bf16=True)
    ref_t, t = both(q, s, b, 8, g)
    x = _x((M, K), "bfloat16", seed=13 * M + g)
    ref = np.asarray(jqmm.quantized_matmul_pallas(jnp.asarray(x), ref_t,
                                                  interpret=True))
    got = fold_emulation(_torch(x), t, splits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=1e-2 * float(np.abs(ref).max()))


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("M", [9, 58, 100])
@pytest.mark.parametrize("K_", [96, 3616])
def test_int8_half_stage_emulation_matches_pallas(K_, M, splits):
    """The 8-bit GEMM at g = 32 with K an odd multiple of 32 (3 and 113
    groups): the last stage is half a stage whose missing group adds
    nothing (zero x and codes, s = b = 0), and the split counts it as a
    unit; the fold emulation with that split against the reference's
    _qmm8_kernel in interpret mode, within K5_TOL = 1e-2 * max|ref|."""
    g = 32
    assert K_ % 64 == 32
    units = -(-K_ // 64)
    if splits > units:
        splits = units
    q, s, b = mlx_weight(8, g, seed=8100 + K_ + M, k=K_, bf16=True)
    ref_t, t = both(q, s, b, 8, g)
    x = _x((M, K_), "bfloat16", seed=17 * M + K_)
    ref = np.asarray(jqmm.quantized_matmul_pallas(jnp.asarray(x), ref_t,
                                                  interpret=True))
    got = fold_emulation(_torch(x), t, splits)
    assert tuple(got.shape) == ref.shape
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=1e-2 * float(np.abs(ref).max()))
    bm, plan_splits = k5.qmatmul_plan(M, K_, 512, g, bits=8)
    assert 1 <= plan_splits <= units


def _and_or(v, mask, bits):
    """csrc/qmatmul.cu's and_or (one LOP3): (v & mask) | bits."""
    return (v & mask) | bits


def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode): byte i of the result is byte
    sel[4i:4i+4] & 7 of the pair (b:a), sign-replicated if bit 3 is set."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)]
    src += [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = 0
    for i in range(4):
        n = (sel >> (4 * i)) & 0xF
        byte = src[n & 7]
        if n & 8:
            byte = 0xFF if byte & 0x80 else 0
        out |= byte << (8 * i)
    return out


def _bf16_halves(w):
    """The two bf16 values of a 32-bit word (low half first) as floats."""
    h = np.array([w & 0xFFFF, w >> 16], dtype=np.uint16)
    return h.view(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("half", [0, 1])
def test_int8_parts_are_exact(half):
    """For all 256 code bytes, in either half of a pair register (with the
    junk that the PRMT leaves in bytes 1 and 3 and the pair's other code
    beside it), the kernel's two LOP3 patterns decode to exactly 128 + low
    nibble (bf16 0x4300 | l) and 256 + 16 high nibble (bf16 0x4380 | h << 3),
    which sum to 384 + the byte."""
    for byte in range(256):
        v = (0xA5 << 8) | (0x5A << 24) | (0xC3 << (16 * (1 - half)))
        v |= byte << (16 * half)
        lo = _bf16_halves(_and_or(v, 0x000F000F, 0x43004300))[half]
        hi = _bf16_halves(_and_or(v >> 1, 0x00780078, 0x43804380))[half]
        assert lo == 128 + (byte & 0xF)
        assert hi == 256 + 16 * (byte >> 4)
        assert lo + hi == 384 + byte


def test_int8_fragments_match_the_wgmma_layout():
    """q8_fragments replayed in numpy for every consumer thread of a block
    and both halves of a stage: a 128 x 64-byte code box as TMA's 64-byte
    swizzle lays it out (16-byte chunk c of row r at chunk c ^ ((r >> 1) %
    4)), the thread's 16-byte reads, PRMT with sel = 2t | (2t + 1) << 8 and
    the two LOP3s, held to the wgmma A fragment of slice kk: register j
    holds W row r0 + (j & 1) at k = 16 kk + 2t + 8 (j >> 1) (+1 in the high
    half), lo parts in a[2i], hi parts in a[2i + 1].  Each quarter warp's
    distinct 16-byte reads fall on distinct bank groups."""
    codes = np.random.default_rng(14).integers(0, 256, (128, 64),
                                               dtype=np.uint8)
    box = np.zeros(128 * 64, dtype=np.uint8)
    for r in range(128):
        for c in range(4):
            at = 64 * r + 16 * (c ^ ((r >> 1) & 3))
            box[at:at + 16] = codes[r, 16 * c:16 * c + 16]
    words = box.view("<u4").astype(np.int64)
    for warp in range(8):
        wg, w = warp // 4, warp % 4
        for h in range(2):
            reads = {}
            for lane in range(32):
                g8, t = lane // 4, lane % 4
                r0, sw = 64 * wg + 16 * w + 2 * g8, g8 & 3
                sel = (2 * t) | ((2 * t + 1) << 8)
                a = [[0] * 4 for _ in range(4)]
                for i in range(2):
                    c = (2 * h + i) ^ sw
                    for row in range(2):
                        at = 64 * (r0 + row) + 16 * c
                        reads.setdefault((lane // 8, i, row), set()).add(at)
                        u = words[at // 4:at // 4 + 4]
                        v0, v1 = _prmt(u[0], u[1], sel), _prmt(u[2], u[3], sel)
                        a[2 * i][row] = _and_or(v0, 0x000F000F, 0x43004300)
                        a[2 * i][2 + row] = _and_or(v1, 0x000F000F,
                                                    0x43004300)
                        a[2 * i + 1][row] = _and_or(v0 >> 1, 0x00780078,
                                                    0x43804380)
                        a[2 * i + 1][2 + row] = _and_or(v1 >> 1, 0x00780078,
                                                        0x43804380)
                for i in range(2):
                    kk = 2 * h + i
                    for j in range(4):
                        row = r0 + (j & 1)
                        k0 = 16 * kk + 2 * t + 8 * (j >> 1)
                        want = codes[row, k0:k0 + 2].astype(np.float32)
                        np.testing.assert_array_equal(
                            _bf16_halves(a[2 * i][j]), 128 + want % 16)
                        np.testing.assert_array_equal(
                            _bf16_halves(a[2 * i + 1][j]),
                            256 + 16 * (want // 16))
            for ats in reads.values():
                assert len({at % 128 // 16 for at in ats}) == len(ats)


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
    """The GEMV takes 1 to 8 rows, K a whole number of its units (whole
    groups and whole 32-byte steps of a row: any number of groups at 8
    bits, group pairs at 4 bits and g = 32) and 4-byte aligned scales and
    biases (they travel as 32-bit words); it refuses anything else before
    it reaches the kernel library (CPU tensors show it)."""
    for M in (0, 9):
        with pytest.raises(ValueError, match="GEMV"):
            k5.qmatmul_gemv_plan(M, K, N, 4, 64)
    with pytest.raises(ValueError, match="64-code units"):
        k5.qmatmul_gemv_plan(1, 96, N, 4, 32)
    k5.qmatmul_gemv_plan(1, 64, N, 8, 32)  # two groups: taken
    k5.qmatmul_gemv_plan(1, 96, N, 8, 32)  # three groups: taken
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


@pytest.mark.cuda
@pytest.mark.parametrize("M", [9, 58, 512])
@pytest.mark.parametrize("g", [32, 64, 128])
def test_cuda_k5_int8_gemm(cuda_device, g, M):
    """The 8-bit GEMM route at ragged N (1000) against the plain version
    (1e-2 * max|ref|, as above) and the fold emulation, one counted call,
    and a repeated call bit-identical (the split-K slices are added in a
    fixed order)."""
    q, s, b = mlx_weight(8, g, seed=150 + g + M, n=1000, k=1024, bf16=True)
    _, t = both(q, s, b, 8, g)
    t = tq.QuantizedTensor(q=t.q.to(cuda_device), scales=t.scales.to(cuda_device),
                           biases=t.biases.to(cuda_device), bits=8,
                           group_size=g, out_dtype="bfloat16")
    x = _torch(_x((M, 1024), "bfloat16", seed=M + 8)).to(cuda_device)
    n0 = k5.launches["qmatmul_int8"]
    got = k5.quantized_matmul_kernel(x, t)
    again = k5.quantized_matmul_kernel(x, t)
    ref = k5.qmatmul_plain(x, t)
    torch.cuda.synchronize()
    assert k5.launches["qmatmul_int8"] == n0 + 2
    assert torch.equal(got, again)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())
    _, splits = k5.qmatmul_plan(M, 1024, 1000, g, bits=8)
    emu = fold_emulation(x.cpu(), tq.QuantizedTensor(
        q=t.q.cpu(), scales=t.scales.cpu(), biases=t.biases.cpu(), bits=8,
        group_size=g, out_dtype="bfloat16"), splits)
    err = float((got.cpu().float() - emu.float()).abs().max())
    assert err <= 1e-2 * float(emu.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [9, 58, 100, 512])
@pytest.mark.parametrize("Kh", [96, 3616])
def test_cuda_k5_int8_gemm_half_stage(cuda_device, Kh, M):
    """K an odd multiple of 32 at g = 32 (3 and 113 groups): the GEMM's
    trailing half stage against the plain version and the fold emulation
    (1e-2 * max|ref|), bit-identical on a repeat, at both row tiles and
    with K split."""
    q, s, b = mlx_weight(8, 32, seed=170 + Kh + M, n=1000, k=Kh, bf16=True)
    _, t = both(q, s, b, 8, 32)
    t = tq.QuantizedTensor(q=t.q.to(cuda_device), scales=t.scales.to(cuda_device),
                           biases=t.biases.to(cuda_device), bits=8,
                           group_size=32, out_dtype="bfloat16")
    x = _torch(_x((M, Kh), "bfloat16", seed=M + 31)).to(cuda_device)
    got = k5.quantized_matmul_kernel(x, t)
    assert torch.equal(k5.quantized_matmul_kernel(x, t), got)
    ref = k5.qmatmul_plain(x, t)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())
    _, splits = k5.qmatmul_plan(M, Kh, 1000, 32, bits=8)
    emu = fold_emulation(x.cpu(), tq.QuantizedTensor(
        q=t.q.cpu(), scales=t.scales.cpu(), biases=t.biases.cpu(), bits=8,
        group_size=32, out_dtype="bfloat16"), splits)
    err = float((got.cpu().float() - emu.float()).abs().max())
    assert err <= 1e-2 * float(emu.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kb,Nb,g", [(512, 3584, 512, 32),
                                       (58, 3584, 512, 64)])
def test_cuda_k5_int8_gemm_split_is_repeatable(cuda_device, M, Kb, Nb, g):
    """A narrow weight splits K (8 slices at M = 512, 33 at a 58-row chunk)
    and gives the same bits on every call."""
    assert k5.qmatmul_plan(M, Kb, Nb, g, bits=8)[1] > 1
    q, s, b = mlx_weight(8, g, seed=19, n=Nb, k=Kb, bf16=True)
    _, t = both(q, s, b, 8, g)
    t = tq.QuantizedTensor(q=t.q.to(cuda_device), scales=t.scales.to(cuda_device),
                           biases=t.biases.to(cuda_device), bits=8,
                           group_size=g, out_dtype="bfloat16")
    x = _torch(_x((M, Kb), "bfloat16", seed=5)).to(cuda_device)
    first = k5.quantized_matmul_kernel(x, t)
    for _ in range(3):
        assert torch.equal(k5.quantized_matmul_kernel(x, t), first)
    ref = k5.qmatmul_plain(x, t)
    torch.cuda.synchronize()
    err = float((first.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())
