"""Port parity: core/moe.py and K5's expert-indexed entry against the JAX
package's core/moe.py, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: in float32, rtol 1e-5 (with atol 1e-6 * max|ref|): the port's
card routes add a token's k expert outputs in f32 where the reference adds
them in ascending expert order, so the sums differ by f32 reassociation
only.  In bfloat16, 2e-2 * max|ref|: the reference rounds each expert's
product and each of the k adds to bf16 (about 2^-8 relative each), the
port's scan the same roundings in torch's order.

- `topk_router`, `switch_glu` (dense f32, dense bf16, mlx 4-bit stacks,
  with biases and a custom activation), `switch_mlp` and
  `group_expert_select` against the JAX functions; the k-th and (k+1)-th
  router scores of every input differ by 1e-4 or more, so that the order
  of ties (torch's `topk` against `jax.lax.top_k`) does not enter;
- the card routes' plain versions (the decode route's indexed pairs, the
  prefill route's grouping by expert) against the reference's masked scan
  at N = 1, 4, 40 and 512 tokens, with experts chosen by several tokens and
  an expert that no token chose;
- the decode route makes no host read (a TorchDispatchMode that raises on
  `aten._local_scalar_dense`, `aten.nonzero` and `aten.masked_select`);
  the prefill route refuses to run inside a CUDA-graph capture;
- K5's expert-indexed entry: its plain version against K5's plain version
  pair by pair, its route rule and its refusals before any launch; marked
  `cuda`, the kernel against its plain version on a GPU.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from mlx_vlm_tpu.core import moe as jmoe
from mlx_vlm_tpu.core import quant as jq
from mlx_vlm_tpu_torch.core import moe
from mlx_vlm_tpu_torch.core import quant as tq
from mlx_vlm_tpu_torch.ops import qmatmul as k5

torch.set_num_threads(2)

F32_RTOL = 1e-5
BF16_TOL = 2e-2


def _assert_f32(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref,
                               rtol=F32_RTOL,
                               atol=1e-6 * max(1.0, float(np.abs(ref).max())))


def _router_inputs(N, D, E, k, seed):
    """x [N, D] and a router [E, D] whose softmax scores keep a gap of 1e-4
    or more between the k-th and the (k+1)-th of every row: the draws of
    the first seed from `seed` on whose scores do."""
    for s in range(seed, seed + 1000):
        rng = np.random.default_rng(s)
        x = rng.standard_normal((N, D)).astype(np.float32)
        gate = rng.standard_normal((E, D)).astype(np.float32) * 0.3
        logits = x @ gate.T
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        srt = np.sort(p, axis=-1)[:, ::-1]
        if np.all(srt[:, k - 1] - srt[:, k] >= 1e-4):
            return x, gate
    raise AssertionError("no seed gives separated scores")


def _stacks(E, I, D, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, I, D)).astype(np.float32) * scale,
            rng.standard_normal((E, I, D)).astype(np.float32) * scale,
            rng.standard_normal((E, D, I)).astype(np.float32) * scale)


def _quantized(w, bits=4, g=32):
    """(JAX QuantizedTensor, port QuantizedTensor) of the same codes."""
    ref = jq.quantize(jnp.asarray(w), bits=bits, group_size=g)
    got = tq.QuantizedTensor(
        q=torch.from_numpy(np.array(ref.q)),
        scales=torch.from_numpy(np.array(ref.scales)),
        biases=torch.from_numpy(np.array(ref.biases)), bits=bits,
        group_size=g, out_dtype="float32")
    return ref, got


def _routing(N, E, k, seed, skip=(0,)):
    """indices [N, k] (distinct experts a row, never those in `skip`, so
    that some expert has no rows) and positive weights that sum to 1."""
    rng = np.random.default_rng(seed)
    pool = np.array([e for e in range(E) if e not in skip])
    idx = np.stack([rng.choice(pool, k, replace=False) for _ in range(N)])
    w = rng.uniform(0.1, 1.0, (N, k)).astype(np.float32)
    return idx.astype(np.int64), w / w.sum(-1, keepdims=True)


# ----------------------------------------------------------- routers


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("N,D,E,k,seed", [(6, 8, 4, 2, 0), (9, 16, 8, 3, 1),
                                          (33, 32, 16, 8, 2),
                                          (5, 64, 128, 8, 3)])
def test_topk_router_matches_jax(N, D, E, k, seed, norm):
    x, gate = _router_inputs(N, D, E, k, seed)
    ri, rw = jmoe.topk_router(jnp.asarray(x), jnp.asarray(gate), k, norm)
    gi, gw = moe.topk_router(torch.from_numpy(x), torch.from_numpy(gate), k,
                             norm)
    assert gi.shape == (N, k) and gw.dtype == torch.float32
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    _assert_f32(gw.numpy(), rw)
    if norm:
        np.testing.assert_allclose(gw.sum(-1).numpy(), 1.0, atol=1e-6)


def test_topk_router_on_an_8bit_router():
    """An mlx 8-bit router (the per-path override of MoE conversions) runs
    through `linear`'s K5 route, as the reference's through its own."""
    x, gate = _router_inputs(7, 64, 16, 4, 4)
    ref_t, t = _quantized(gate, bits=8, g=64)
    ri, rw = jmoe.topk_router(jnp.asarray(x), ref_t, 4)
    gi, gw = moe.topk_router(torch.from_numpy(x), t, 4)
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    _assert_f32(gw.numpy(), rw)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("n_group,topk_group", [(1, 1), (4, 2), (8, 3)])
def test_group_expert_select_matches_jax(n_group, topk_group, norm):
    rng = np.random.default_rng(10 * n_group + topk_group)
    N, E, k = 11, 32, 6
    logits = rng.standard_normal((N, E)).astype(np.float32)
    bias = rng.standard_normal(E).astype(np.float32) * 0.1
    args = (k, n_group, topk_group, 2.5, norm)
    ri, rw = jmoe.group_expert_select(jnp.asarray(logits), jnp.asarray(bias),
                                      *args)
    gi, gw = moe.group_expert_select(torch.from_numpy(logits),
                                     torch.from_numpy(bias), *args)
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    _assert_f32(gw.numpy(), rw)


# ----------------------------------------------------------- expert MLPs


@pytest.mark.parametrize("N,E,k", [(6, 4, 2), (17, 8, 3), (40, 16, 8)])
def test_switch_glu_dense_f32_matches_jax(N, E, k):
    D, I = 16, 24
    x, gate = _router_inputs(N, D, E, k, N)
    wg, wu, wd = _stacks(E, I, D, N + 1)
    idx, wts = jmoe.topk_router(jnp.asarray(x), jnp.asarray(gate), k)
    ref = jmoe.switch_glu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                          jnp.asarray(wd), idx, wts)
    t = torch.from_numpy
    got = moe.switch_glu(t(x), t(wg), t(wu), t(wd),
                         t(np.array(idx)).long(), t(np.array(wts)))
    assert got.dtype == torch.float32 and got.shape == (N, D)
    _assert_f32(got.numpy(), ref)


def test_switch_glu_dense_bf16_matches_jax():
    """bf16 x and stacks, within BF16_TOL * max|ref| (module docstring)."""
    N, D, I, E, k = 12, 32, 48, 8, 2
    x, gate = _router_inputs(N, D, E, k, 5)
    wg, wu, wd = _stacks(E, I, D, 6)
    idx, wts = jmoe.topk_router(jnp.asarray(x), jnp.asarray(gate), k)
    bf = jnp.bfloat16
    ref = np.asarray(jmoe.switch_glu(
        jnp.asarray(x, bf), jnp.asarray(wg, bf), jnp.asarray(wu, bf),
        jnp.asarray(wd, bf), idx, wts).astype(jnp.float32))
    b = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = moe.switch_glu(b(x), b(wg), b(wu), b(wd),
                         torch.from_numpy(np.array(idx)).long(),
                         torch.from_numpy(np.array(wts)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=BF16_TOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("g", [32, 64])
def test_switch_glu_mlx4_stacks_match_jax(g):
    N, D, I, E, k = 10, 64, 128, 8, 2
    x, gate = _router_inputs(N, D, E, k, 7)
    stacks = [_quantized(w, 4, g) for w in _stacks(E, I, D, 8)]
    idx, wts = jmoe.topk_router(jnp.asarray(x), jnp.asarray(gate), k)
    ref = jmoe.switch_glu(jnp.asarray(x), *[r for r, _ in stacks], idx, wts)
    got = moe.switch_glu(torch.from_numpy(x), *[p for _, p in stacks],
                         torch.from_numpy(np.array(idx)).long(),
                         torch.from_numpy(np.array(wts)))
    _assert_f32(got.numpy(), ref)


def test_switch_glu_biases_and_activation_match_jax():
    N, D, I, E, k = 8, 16, 20, 4, 2
    x, gate = _router_inputs(N, D, E, k, 9)
    wg, wu, wd = _stacks(E, I, D, 10)
    rng = np.random.default_rng(11)
    biases = [rng.standard_normal(s).astype(np.float32) * 0.1
              for s in ((E, I), (E, I), (E, D))]
    idx, wts = jmoe.topk_router(jnp.asarray(x), jnp.asarray(gate), k)
    jact = lambda g, u: jnp.tanh(g) * u  # noqa: E731
    tact = lambda g, u: torch.tanh(g) * u  # noqa: E731
    ref = jmoe.switch_glu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                          jnp.asarray(wd), idx, wts, act2=jact,
                          biases=tuple(jnp.asarray(b) for b in biases))
    t = torch.from_numpy
    ti, tw = t(np.array(idx)).long(), t(np.array(wts))
    for fn in (moe.switch_glu, moe.switch_glu_scan):
        got = fn(t(x), t(wg), t(wu), t(wd), ti, tw, act2=tact,
                 biases=tuple(t(b) for b in biases))
        _assert_f32(got.numpy(), ref)
    for route in (moe.pairs_route, moe.grouped_route):
        got = route(t(x), (t(wg), t(wu)), t(wd), ti, tw, tact,
                    tuple(t(b) for b in biases))
        _assert_f32(got.numpy(), ref)


@pytest.mark.parametrize("with_biases", [False, True])
def test_switch_mlp_matches_jax(with_biases):
    N, D, I, E, k, Do = 9, 16, 32, 6, 2, 12
    x, gate = _router_inputs(N, D, E, k, 12)
    rng = np.random.default_rng(13)
    wu = rng.standard_normal((E, I, D)).astype(np.float32) * 0.1
    wd = rng.standard_normal((E, Do, I)).astype(np.float32) * 0.1
    biases = None
    if with_biases:
        biases = (rng.standard_normal((E, I)).astype(np.float32) * 0.1,
                  rng.standard_normal((E, Do)).astype(np.float32) * 0.1)
    idx, wts = jmoe.topk_router(jnp.asarray(x), jnp.asarray(gate), k)
    ref = jmoe.switch_mlp(jnp.asarray(x), jnp.asarray(wu), jnp.asarray(wd),
                          idx, wts, biases=None if biases is None else tuple(
                              jnp.asarray(b) for b in biases))
    t = torch.from_numpy
    tb = None if biases is None else tuple(t(b) for b in biases)
    ti, tw = t(np.array(idx)).long(), t(np.array(wts))
    got = moe.switch_mlp(t(x), t(wu), t(wd), ti, tw, biases=tb)
    assert got.shape == (N, Do)
    _assert_f32(got.numpy(), ref)
    relu2 = lambda v: torch.square(torch.relu(v))  # noqa: E731
    for route in (moe.pairs_route, moe.grouped_route):
        _assert_f32(route(t(x), (t(wu),), t(wd), ti, tw, relu2, tb).numpy(),
                    ref)


# ----------------------------------------------------------- card routes


@pytest.mark.parametrize("N", [1, 4, 40, 512])
@pytest.mark.parametrize("route", ["pairs", "grouped"])
@pytest.mark.parametrize("stack", ["mlx4", "dense"])
def test_card_routes_match_the_masked_scan(N, route, stack):
    """The card routes' plain versions (K5's plain version in place of the
    kernel) against the reference's masked scan (the JAX package's
    `switch_glu`) and the port's: every pair of a token routed, experts
    shared by many tokens, expert 0 chosen by none."""
    D, I, E, k = 64, 32, 16, 4
    rng = np.random.default_rng(N)
    x = rng.standard_normal((N, D)).astype(np.float32)
    idx, wts = _routing(N, E, k, N + 1)
    dense = _stacks(E, I, D, N + 2)
    if stack == "mlx4":
        pairs = [_quantized(w, 4, 32) for w in dense]
        ref_w, port_w = [r for r, _ in pairs], [p for _, p in pairs]
    else:
        ref_w = [jnp.asarray(w) for w in dense]
        port_w = [torch.from_numpy(w) for w in dense]
    ref = jmoe.switch_glu(jnp.asarray(x), *ref_w, jnp.asarray(idx),
                          jnp.asarray(wts))
    tx, ti, tw = (torch.from_numpy(a) for a in (x, idx, wts))
    fn = moe.pairs_route if route == "pairs" else moe.grouped_route
    before = dict(moe.stats)
    got = fn(tx, tuple(port_w[:2]), port_w[2], ti, tw, moe._silu_glu)
    _assert_f32(got.numpy(), ref)
    _assert_f32(got.numpy(), moe.switch_glu_scan(tx, *port_w, ti, tw).numpy())
    if route == "grouped":  # every chosen expert ran once, expert 0 never
        used = len(np.unique(idx))
        assert 0 not in idx
        assert moe.stats["grouped_experts"] - before["grouped_experts"] == used
        assert moe.stats["grouped_calls"] - before["grouped_calls"] == 1


class _NoHostReads(TorchDispatchMode):
    """Raises on every operator that reads a device value on the host or
    gives a shape that depends on the data: `_local_scalar_dense` (`.item()`
    and its kind), `nonzero`, `masked_select`, and indexing by a boolean
    mask (`aten::index` with a bool index, which takes `nonzero` below the
    dispatcher)."""

    FORBIDDEN = ("aten::_local_scalar_dense", "aten::nonzero",
                 "aten::masked_select")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in self.FORBIDDEN or (name == "aten::index" and any(
                i is not None and i.dtype in (torch.bool, torch.uint8)
                for i in args[1])):
            raise AssertionError(f"host read: {name}")
        return func(*args, **(kwargs or {}))


def test_decode_route_makes_no_host_read():
    """The decode route over mlx stacks (K5's expert-indexed entry, its
    plain version here) and dense stacks runs under a dispatch mode that
    raises on a host read; the mode itself catches one (`.item()`,
    boolean indexing), and the prefill route's per-expert counts."""
    N, D, I, E, k = 5, 64, 32, 8, 2
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    gate = torch.from_numpy(rng.standard_normal((E, D)).astype(np.float32))
    dense = _stacks(E, I, D, 21)
    for stacks in ([_quantized(w)[1] for w in dense],
                   [torch.from_numpy(w) for w in dense]):
        with _NoHostReads():
            idx, wts = moe.topk_router(x, gate, k)
            out = moe.pairs_route(x, tuple(stacks[:2]), stacks[2], idx, wts,
                                  moe._silu_glu)
        ref = moe.switch_glu_scan(x, *stacks, idx, wts)
        _assert_f32(out.numpy(), ref.numpy())
    for read in (lambda: x.sum().item(), lambda: x[x > 0]):
        with pytest.raises(AssertionError, match="host read"):
            with _NoHostReads():
                read()


def test_prefill_route_refuses_inside_a_capture(monkeypatch):
    """Inside a capture (here, `_capturing` made to say so) the grouped
    route raises before it reads anything, where it would fetch its
    per-expert counts; `_route` never sends a capture there."""
    N, D, I, E, k = 80, 16, 8, 4, 2
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    idx, wts = (torch.from_numpy(a) for a in _routing(N, E, k, 23))
    stacks = [torch.from_numpy(w) for w in _stacks(E, I, D, 24)]
    monkeypatch.setattr(moe, "_capturing", lambda x: True)
    before = dict(moe.stats)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        moe.grouped_route(x, tuple(stacks[:2]), stacks[2], idx, wts,
                          moe._silu_glu)
    assert moe.stats == before


def test_route_choice_by_device_and_shape(monkeypatch):
    """On the CPU every call takes the masked scan; on the card (here, CUDA
    made to be claimed) at most PREFILL_MIN_TOKENS tokens, or any count
    inside a capture, take the pairs; more tokens, eager, the grouping; a
    stack the kernel does not take (group 16), the scan."""
    seen = []
    for name in ("pairs_route", "grouped_route", "_scan"):
        monkeypatch.setattr(moe, name, lambda *a, _n=name: seen.append(_n))
    D, I, E = 64, 64, 4
    stacks = [_quantized(w)[1] for w in _stacks(E, I, D, 25)]
    odd = [_quantized(w, 4, 16)[1] for w in _stacks(E, I, D, 25)]

    class Fake:
        def __init__(self, n, cuda):
            self.shape = (n, D)
            self.device = torch.device("cuda" if cuda else "cpu")
            self.is_cuda = cuda

    idx = wts = None
    capturing = [False]
    monkeypatch.setattr(moe, "_capturing", lambda x: capturing[0])
    moe.switch_glu(Fake(3, False), *stacks, idx, wts)
    moe.switch_glu(Fake(moe.PREFILL_MIN_TOKENS, True), *stacks, idx, wts)
    moe.switch_glu(Fake(moe.PREFILL_MIN_TOKENS + 1, True), *stacks, idx, wts)
    moe.switch_glu(Fake(3, True), *odd, idx, wts)
    capturing[0] = True
    moe.switch_glu(Fake(512, True), *stacks, idx, wts)
    assert seen == ["_scan", "pairs_route", "grouped_route", "_scan",
                    "pairs_route"]


# ----------------------------------------------------------- K5's entry


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("bits,g", [(4, 32), (4, 64), (8, 64), (8, 128)])
def test_experts_plain_matches_k5_plain_pair_by_pair(bits, g, rows):
    E, N, K, P = 6, 40, 256, 9
    rng = np.random.default_rng(bits + g)
    w = rng.standard_normal((E, N, K)).astype(np.float32) * 0.1
    _, t = _quantized(w, bits, g)
    x = torch.from_numpy(rng.standard_normal((4 if rows else P, K)).astype(
        np.float32))
    experts = torch.tensor([5, 0, 5, 3, 3, 3, 1, 0, 5], dtype=torch.int32)
    r = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, 3], dtype=torch.int32)
    got = k5.quantized_matmul_experts(x, t, experts, r if rows else None)
    assert got.shape == (P, N) and got.dtype == x.dtype
    for p in range(P):
        want = k5.qmatmul_plain(x[int(r[p]) if rows else p][None],
                                t.layer(int(experts[p])))
        np.testing.assert_allclose(got[p].numpy(), want[0].numpy(),
                                   rtol=F32_RTOL, atol=F32_RTOL)
    assert k5.launches["qmatmul_experts"] == 0  # the CPU launches nothing


def test_experts_kernel_route():
    def stack(bits, g, N, K, E=4):
        return tq.QuantizedTensor(
            q=torch.zeros((E, N, K * bits // 8), dtype=torch.uint8),
            scales=torch.zeros((E, N, K // g)),
            biases=torch.zeros((E, N, K // g)), bits=bits, group_size=g,
            out_dtype="bfloat16")

    # Qwen3-VL-30B-A3B's experts: gate / up [128, 768, 2048], down
    # [128, 2048, 768], 4 bits, g = 64
    assert k5.experts_kernel_route(stack(4, 64, 768, 2048, 128))
    assert k5.experts_kernel_route(stack(4, 64, 2048, 768, 128))
    assert k5.experts_kernel_route(stack(8, 32, 100, 96))
    assert not k5.experts_kernel_route(stack(4, 16, 64, 64))  # group 16
    assert not k5.experts_kernel_route(stack(4, 32, 64, 32))  # half a unit
    assert not k5.experts_kernel_route(stack(8, 128, 3, 128))  # N K / g odd
    assert not k5.experts_kernel_route(stack(4, 64, 64, 128).layer(0))
    assert not k5.experts_kernel_route(torch.zeros((4, 8, 8)))


def test_experts_refusals_before_any_launch():
    """The wrapper's checks read shapes, dtypes and addresses only; on CPU
    tensors they refuse as on the card, before the kernel library."""
    E, N, K = 4, 64, 128
    t = tq.QuantizedTensor(
        q=torch.zeros((E, N, K // 2), dtype=torch.uint8),
        scales=torch.zeros((E, N, K // 64), dtype=torch.bfloat16),
        biases=torch.zeros((E, N, K // 64), dtype=torch.bfloat16), bits=4,
        group_size=64, out_dtype="bfloat16")
    x = torch.zeros((3, K), dtype=torch.bfloat16)
    e = torch.zeros(6, dtype=torch.int32)
    r = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(TypeError, match="CUDA"):
        k5._check_experts(x, t, e, r)
    k5._check_experts_args(x, t, e, r)  # what the kernel takes
    cases = [  # (x, t, experts, rows, what the refusal says)
        (x.float(), t, e, r, "bfloat16"),
        (torch.zeros((3, 96), dtype=torch.bfloat16), t, e, r, "match K"),
        (x, t, e.long(), r, "int32"),
        (x, t, e, r[:5], "int32"),
        (x, t, e, None, "one row a pair"),
        (x, t, e[:0], r[:0], "pairs"),
        (x, tq.QuantizedTensor(q=t.q, scales=t.scales.float(),
                               biases=t.biases, bits=4, group_size=64,
                               out_dtype="bfloat16"), e, r, "bfloat16"),
        (x, tq.QuantizedTensor(q=t.q, scales=t.scales, biases=t.biases,
                               bits=4, group_size=16, out_dtype="bfloat16"),
         e, r, "not taken"),
    ]
    for xx, tt, ee, rr, match in cases:
        with pytest.raises((TypeError, ValueError), match=match):
            k5._check_experts_args(xx, tt, ee, rr)
    assert k5.launches["qmatmul_experts"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P", [8, 32, 40])
def test_cuda_experts_kernel_matches_plain(cuda_device, P):
    """K5's expert-indexed GEMV at Qwen3-VL-30B-A3B's expert shapes against
    its plain version (1e-2 * max|ref|, both rounding once to bf16),
    bit-identical on a repeat, one launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(P)
    for N, K in ((768, 2048), (2048, 768)):
        E = 128
        t = tq.QuantizedTensor(
            q=torch.randint(0, 256, (E, N, K // 2), generator=gen,
                            device=cuda_device, dtype=torch.uint8),
            scales=(torch.rand((E, N, K // 64), generator=gen,
                               device=cuda_device) * 1e-3 + 1e-3).to(
                                   torch.bfloat16),
            biases=torch.full((E, N, K // 64), -7.5e-3, device=cuda_device,
                              dtype=torch.bfloat16), bits=4, group_size=64,
            out_dtype="bfloat16")
        experts = torch.randint(0, E, (P,), generator=gen,
                                device=cuda_device, dtype=torch.int32)
        experts[0], experts[1], experts[-1] = 127, 127, 3
        rows = (torch.arange(P, device=cuda_device) // 8).to(torch.int32)
        x = torch.randn((P // 8 + 1, K), generator=gen,
                        device=cuda_device).to(torch.bfloat16)
        before = k5.launches["qmatmul_experts"]
        out = k5.quantized_matmul_experts(x, t, experts, rows)
        ref = k5.qmatmul_experts_plain(x, t, experts, rows)
        torch.cuda.synchronize()
        tol = 1e-2 * float(ref.float().abs().max())
        assert float((out.float() - ref.float()).abs().max()) <= tol
        assert torch.equal(k5.quantized_matmul_experts(x, t, experts, rows),
                           out)
        assert k5.launches["qmatmul_experts"] - before == 2
