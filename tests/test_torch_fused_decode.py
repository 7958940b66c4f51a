"""Port parity: the whole-stack fused int4 decode step (K3).

`fused_decode_step_plain` is held to the JAX package's manual-DMA kernel
`fused_decode_step_manual(..., interpret=True)` (its TPU route: z2 math,
fused lm_head) on the same weights and inputs, at the sizes of the JAX
package's own fused-decode tests (hidden 128, intermediate 256, 4/2 heads,
C = 32).  Both run in float32 on the CPU and differ only in the order of
f32 sums (relative 1e-7 to 1e-5).  The first layer's k/v rows, which see
no rounded intermediate yet, agree within 1e-5 * max|ref|.  Every weight
dot rounds x to bf16, so a last-bit difference can flip one element's
rounding (a 2^-9 relative step), and the stack amplifies such flips: h_out,
the later layers' k/v rows and the logits agree within 3e-2 * max|ref| (at
most 1.2e-2 seen over two seeds and three offsets; the JAX package's own
z2-vs-grid test allows atol 0.25 at these sizes), with equal argmax.
Greedy decoding on the port's fused
route is held to the JAX model on its default route (pack attached) with
the bound of the JAX package's `test_fused_matches_unfused_decode`: equal
tokens, logprobs within 0.08 (the JAX CPU route is the grid kernel with
dequant math, the port follows the z2 math).
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.core.quant import quantize, to_int4_grouped
from mlx_vlm_tpu.generate.dispatch import stream_generate as jax_stream
from mlx_vlm_tpu.ops.fused_decode import fused_decode_step_manual
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import qwen2_vl_hf_weights, tiny_qwen2_vl_config
from mlx_vlm_tpu_torch.core.quant import Int4GroupedTensor, _int4_half_width
from mlx_vlm_tpu_torch.generate.dispatch import stream_generate
from mlx_vlm_tpu_torch.models.qwen2_vl import Model, ModelConfig
from mlx_vlm_tpu_torch.models.qwen2_vl import language as language_mod
from mlx_vlm_tpu_torch.ops import fused_decode as fd
from mlx_vlm_tpu_torch.utils.loader import decide_fused_decode, params_from_jax
from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

torch.set_num_threads(2)

EXACT, ROUNDED = 1e-5, 3e-2  # relative to max|ref|, see the docstring
# K3's tolerances on the card (chip_smoke.py FUSED_EXACT / FUSED_ROUNDED):
# the kernel's arithmetic, emulated here, is held to them
FUSED_EXACT, FUSED_ROUNDED = 1e-4, 6e-2
C = 32


def _config(layers=2):
    """The JAX package's fused-head test model (tests/test_fused_decode.py
    `_tiny_int4_head_model`)."""
    cfg = tiny_qwen2_vl_config()
    cfg["hidden_size"] = 128
    cfg["intermediate_size"] = 256
    cfg["num_attention_heads"] = 4
    cfg["num_key_value_heads"] = 2
    cfg["num_hidden_layers"] = layers
    cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [4, 6, 6]}
    cfg["vision_config"]["hidden_size"] = 32
    cfg["tie_word_embeddings"] = False
    return cfg


def _weights(cfg, seed):
    weights = qwen2_vl_hf_weights(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for k in list(weights):
        if ((k.startswith("model.layers.") and k.endswith(".weight")
             and "layernorm" not in k and weights[k].ndim == 2)
                or k == "lm_head.weight"):
            w = rng.standard_normal(weights[k].shape).astype(np.float32) * 0.1
            weights[k] = to_int4_grouped(quantize(jnp.asarray(w), bits=4,
                                                  group_size=64))
    return weights


def _models(layers, seed, **env):
    """(JAX model on its default route, port model from the same params)."""
    cfg = _config(layers)
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        jm = jax_load(dict(cfg), _weights(cfg, seed), jnp.float32)
    finally:
        mp.undo()
    tm = Model(ModelConfig.from_dict(cfg))
    tm.params = params_from_jax(tm, jax.tree_util.tree_map(np.asarray,
                                                           jm.params))
    tm.config_dict = cfg
    tm.device = torch.device("cpu")
    return jm, tm, cfg


@pytest.fixture(scope="module")
def models():
    jm, tm, cfg = _models(2, seed=13)
    pack = jm.params["language_model"]["fused_decode"]
    assert pack.hd_qp is not None and "layers" not in \
        jm.params["language_model"]["model"]
    assert decide_fused_decode(tm)
    return jm, tm, cfg


def _step_inputs(pack, offset, seed=2):
    L, Hkv, hd = pack.n_layers, pack.n_kv, pack.head_dim
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((1, 1, pack.dim)) * 0.3).astype(np.float32)
    cos = (rng.standard_normal(hd // 2) * 0.1 + 1.0).astype(np.float32)
    sin = (rng.standard_normal(hd // 2) * 0.1).astype(np.float32)
    k = (rng.standard_normal((L, 1, Hkv, C, hd)) * 0.2).astype(np.float32)
    v = (rng.standard_normal((L, 1, Hkv, C, hd)) * 0.2).astype(np.float32)
    return h, cos, sin, k, v


def _port_step(tm, h, cos, sin, k, v, offset):
    lm = tm.language_model
    t = [torch.from_numpy(a.copy()) for a in (h, cos, sin, k, v)]
    return fd.fused_decode_step(tm.params["language_model"], lm.args, *t,
                                offset)


@pytest.mark.parametrize("offset", [0, 5, 31])
def test_plain_step_matches_manual_kernel(models, offset):
    jm, tm, _ = models
    pack = jm.params["language_model"]["fused_decode"]
    h, cos, sin, k, v = _step_inputs(pack, offset)
    hj, kj, vj, lj = fused_decode_step_manual(
        pack, *(jnp.asarray(a) for a in (h, cos, sin, k, v)),
        jnp.asarray(offset, jnp.int32), interpret=True)
    L, Hkv = pack.n_layers, pack.n_kv
    ht, kt, vt, lt = _port_step(tm, h, cos, sin, k, v, offset)
    assert ht.shape == (1, 1, pack.dim) and ht.dtype == torch.float32
    assert kt.shape == (L, Hkv * pack.head_dim) and lt.shape == (1, pack.head_n)
    kj = np.asarray(kj)[:, :Hkv].reshape(L, -1)
    vj = np.asarray(vj)[:, :Hkv].reshape(L, -1)

    def close(got, ref, rel):
        err = float(np.abs(got - ref).max())
        assert err <= rel * float(np.abs(ref).max()), (err, rel)

    close(kt.numpy()[0], kj[0], EXACT)
    close(vt.numpy()[0], vj[0], EXACT)
    close(kt.numpy()[1:], kj[1:], ROUNDED)
    close(vt.numpy()[1:], vj[1:], ROUNDED)
    close(ht.numpy(), np.asarray(hj), ROUNDED)
    close(lt.numpy(), np.asarray(lj), ROUNDED)
    assert int(lt.argmax()) == int(np.argmax(lj))


def test_step_ignores_rows_past_offset_and_writes_its_row(models):
    """Garbage past `offset` leaves every output unchanged; the step's own
    k/v rows land at `offset` and the rows after it stay as they were."""
    jm, tm, _ = models
    pack = jm.params["language_model"]["fused_decode"]
    offset = 9
    h, cos, sin, k, v = _step_inputs(pack, offset, seed=4)
    L, Hkv, hd = pack.n_layers, pack.n_kv, pack.head_dim
    kg, vg = k.copy(), v.copy()
    kg[:, :, :, offset:] = 1e3
    vg[:, :, :, offset:] = -1e3
    tk, tv = torch.from_numpy(kg), torch.from_numpy(vg)
    ref = _port_step(tm, h, cos, sin, k, v, offset)
    got = fd.fused_decode_step(
        tm.params["language_model"], tm.language_model.args,
        *(torch.from_numpy(a) for a in (h, cos, sin)), tk, tv, offset)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert torch.equal(tk[:, 0, :, offset], got[1].view(L, Hkv, hd))
    assert torch.equal(tv[:, 0, :, offset], got[2].view(L, Hkv, hd))
    assert bool((tk[:, :, :, offset + 1:] == 1e3).all())
    assert bool((tv[:, :, :, offset + 1:] == -1e3).all())


def test_step_ignores_nan_past_offset(models):
    """NaN past `offset` (a cache slot never written) leaves every output
    as it is with a clean cache: the step reads history [0, offset) only,
    and the kernel's zero-filled rows past the cursor never meet a NaN."""
    jm, tm, _ = models
    pack = jm.params["language_model"]["fused_decode"]
    offset = 9
    h, cos, sin, k, v = _step_inputs(pack, offset, seed=4)
    L, Hkv, hd = pack.n_layers, pack.n_kv, pack.head_dim
    kg, vg = k.copy(), v.copy()
    kg[:, :, :, offset:] = np.nan
    vg[:, :, :, offset:] = np.nan
    tk, tv = torch.from_numpy(kg), torch.from_numpy(vg)
    ref = _port_step(tm, h, cos, sin, k, v, offset)
    got = fd.fused_decode_step(
        tm.params["language_model"], tm.language_model.args,
        *(torch.from_numpy(a) for a in (h, cos, sin)), tk, tv, offset)
    for a, b in zip(ref, got):
        assert bool(torch.isfinite(b).all()) and torch.equal(a, b)
    assert torch.equal(tk[:, 0, :, offset], got[1].view(L, Hkv, hd))
    assert torch.equal(tv[:, 0, :, offset], got[2].view(L, Hkv, hd))
    assert bool(torch.isnan(tk[:, :, :, offset + 1:]).all())
    assert bool(torch.isnan(tv[:, :, :, offset + 1:]).all())


# ------------------------------------------------- the kernel's fold, emulated


def _mv_fold(x, t, trap=False):
    """x [K] f32 @ dequant(t) with the kernel's arithmetic: x_b = bf16(x);
    per group and plane, d = sum x_b (128 + q) with exact codes (the low
    plane summed directly), dx = sum x_b and sx = sum x (unrounded), folded
    as s (d - 128 dx) + b sx.  `trap`: the fold (b - 128 s) sx instead,
    which drops 128 s sum (x_b - x) from every group."""
    K, n2p = t.qp.shape
    g = t.group_size
    G = K // g
    q = t.qp.to(torch.int32).view(G, g, n2p)
    xb = x.to(torch.bfloat16).float().view(G, 1, g)
    dx = xb.sum(-1)                                       # [G, 1]
    sx = x.view(G, g).sum(-1, keepdim=True)
    ys = []
    for plane, s, b in ((q & 15, t.sl, t.bl), (q >> 4, t.sh, t.bh)):
        d = torch.bmm(xb, 128.0 + plane.float())[:, 0]    # [G, n2p]
        s, b = s[:, 0], b[:, 0]
        if trap:
            ys.append((s * d + (b - 128.0 * s) * sx).sum(0))
        else:
            ys.append((s * (d - 128.0 * dx) + b * sx).sum(0))
    return torch.cat(ys)[: t.n]


def _manual_and_fold(models, offset, monkeypatch, trap=False):
    jm, tm, _ = models
    pack = jm.params["language_model"]["fused_decode"]
    h, cos, sin, k, v = _step_inputs(pack, offset)
    hj, kj, vj, lj = fused_decode_step_manual(
        pack, *(jnp.asarray(a) for a in (h, cos, sin, k, v)),
        jnp.asarray(offset, jnp.int32), interpret=True)
    monkeypatch.setattr(fd, "_mv_z2", lambda x, t: _mv_fold(x, t, trap))
    ht, kt, vt, lt = _port_step(tm, h, cos, sin, k, v, offset)
    L, Hkv = pack.n_layers, pack.n_kv
    kj = np.asarray(kj)[:, :Hkv].reshape(L, -1)
    vj = np.asarray(vj)[:, :Hkv].reshape(L, -1)
    return ((kt.numpy()[0], kj[0]), (vt.numpy()[0], vj[0])), (
        (kt.numpy()[1:], kj[1:]), (vt.numpy()[1:], vj[1:]),
        (ht.numpy(), np.asarray(hj)), (lt.numpy(), np.asarray(lj)))


def _rel_err(got, ref):
    return float(np.abs(got - ref).max()) / float(np.abs(ref).max())


@pytest.mark.parametrize("offset", [0, 5, 31])
def test_kernel_fold_matches_manual_kernel(models, monkeypatch, offset):
    """The kernel's fold, emulated on the CPU through the plain step, held
    to the Pallas manual kernel in interpret mode with K3's tolerances on
    the card: FUSED_EXACT on the first layer's k/v, FUSED_ROUNDED beyond."""
    first, rest = _manual_and_fold(models, offset, monkeypatch)
    for got, ref in first:
        assert _rel_err(got, ref) <= FUSED_EXACT
    for got, ref in rest:
        assert _rel_err(got, ref) <= FUSED_ROUNDED


def test_kernel_fold_trap_misses_exact(models, monkeypatch):
    """Folding (b - 128 s) sum x_f32 with codes 128 + q summed against
    bf16 x misses FUSED_EXACT on the first layer's k/v: the fold must
    subtract 128 s sum x_b, as the kernel does."""
    first, _ = _manual_and_fold(models, 5, monkeypatch, trap=True)
    assert max(_rel_err(got, ref) for got, ref in first) > FUSED_EXACT


# ------------------------------------------------------------ the plan

KERNEL_SOURCE = (Path(fd.__file__).resolve().parent.parent / "csrc"
                 / "fused_decode.cu")


def _plan_model(name):
    """(args, shapes without offset) at 7B width or at the tiny config of
    the `cuda` test (head_dim 128, two layers)."""
    from mlx_vlm_tpu_torch.utils.testing import (qwen2_vl_7b_config,
                                                 tiny_qwen2_vl_config)
    if name == "7b":
        cfg, L = qwen2_vl_7b_config(), 28
    else:
        cfg = tiny_qwen2_vl_config(hidden_size=512, intermediate_size=1024,
                                   num_attention_heads=4,
                                   num_key_value_heads=2, vocab_size=1024)
        L = 2
    args = ModelConfig.from_dict(cfg).text_config
    D, I = args.hidden_size, args.intermediate_size
    nkv = args.num_key_value_heads * (D // args.num_attention_heads)
    n2p = tuple(_int4_half_width(n)
                for n in (D, nkv, nkv, D, I, I, D, args.vocab_size))
    return args, L, n2p


@pytest.mark.parametrize("name", ["7b", "tiny"])
@pytest.mark.parametrize("g", [64, 32, 128])
def test_plan_owns_every_tile_once_in_order(name, g):
    """Every weight tile (one quantization group of one 128-column strip)
    of every phase belongs to exactly one block: each block's pieces are
    whole groups, contiguous in the phase's strip-major order, numbered
    within their strip in block order, and a strip's pieces cover [0, K);
    each block's list runs layer by layer, q|k|v, o, gate|up, down, then
    the head, which is the order its producer loads and its consumers use
    them; the ring and the rest of the kernel's shared memory fit in a
    block's 227 KB."""
    args, L, n2p = _plan_model(name)
    plan = fd.fused_decode_plan(
        args, fd.FusedDecodeShapes(L, g, n2p, args.vocab_size), 132)
    assert plan.grid == 132 and plan.phases == 5
    assert plan.smem_bytes + fd.STATIC_BYTES <= 227 * 1024
    assert 2 <= plan.stages <= fd.MAX_STAGES
    assert plan.stage_bytes == fd.Q_BYTES + plan.slots * fd.SLOT_BYTES
    assert plan.slots * g >= fd.BK
    assert plan.seg_rows % fd.BK == 0 and plan.seg_rows % g == 0
    assert plan.seg_rows <= plan.xrows
    for p in range(5):
        K = plan.K[p]
        lins = fd.PHASE_LINEARS[p]
        owned, pieces = {}, {}
        for b in range(plan.grid):
            last = None
            for lin, j0, kb, ke, strip, ord_ in plan.phase_pieces(p, b):
                assert 0 <= kb < ke <= K and kb % g == 0 and ke % g == 0
                assert last is None or (strip, kb) > last
                last = (strip, kb)
                for k in range(kb, ke, g):
                    assert (lin, j0, k) not in owned
                    owned[(lin, j0, k)] = b
                pieces.setdefault(strip, []).append((kb, ke, ord_))
        assert len(owned) == sum(n2p[i] // fd.STRIP for i in lins) * (K // g)
        assert sorted(pieces) == list(range(len(pieces)))
        for strip, ps in pieces.items():
            assert [o for _, _, o in ps] == list(range(len(ps)))
            assert len(ps) == plan.pieces_of(p, strip) <= plan.pmax[p]
            assert ps[0][0] == 0 and ps[-1][1] == K
            for (_, a1, _), (b0, _, _) in zip(ps, ps[1:]):
                assert a1 == b0
        assert plan.part_floats >= len(pieces) * plan.pmax[p] * 2 * fd.STRIP
    key = {(l, p): 5 * l + p for l in range(L) for p in range(4)}
    for b in range(plan.grid):
        order = [(key.get((l, p), 5 * L), lin, j0, kb)
                 for l, p, lin, j0, kb, _ in plan.block_tiles(b)]
        assert order == sorted(order)
    rows = sum(ke - kb for b in range(plan.grid)
               for _, _, _, _, kb, ke in plan.block_tiles(b))
    assert rows == sum((L if p < 4 else 1) * plan.K[p] * sum(
        n2p[i] // fd.STRIP for i in fd.PHASE_LINEARS[p]) for p in range(5))


@pytest.mark.parametrize("name", ["7b", "tiny"])
@pytest.mark.parametrize("offset", [0, 1, 63, 64, 65, 300, 8545])
def test_plan_chunks_cover_history(name, offset):
    """The attention chunks at a cursor of `offset` (the kernel derives
    their count from its cursor word by `chunks_at`'s rule) cover
    [0, offset) exactly, each a whole number of 64-token tiles but the
    last, never more units than blocks; at 8.5k tokens every block of the
    7B grid gets a unit."""
    args, L, n2p = _plan_model(name)
    plan = fd.fused_decode_plan(
        args, fd.FusedDecodeShapes(L, 64, n2p, args.vocab_size), 132)
    chunks = plan.chunk_tokens(offset)
    n = plan.chunks_at(offset)
    assert len(chunks) == n <= plan.max_chunks
    assert n * args.num_key_value_heads <= plan.grid
    assert chunks[0][0] == 0 and chunks[-1][1] == offset
    for (a0, a1), (b0, _) in zip(chunks, chunks[1:]):
        assert a1 == b0 and a0 % fd.T_TILE == 0
    if offset:
        assert all(a1 > a0 for a0, a1 in chunks)
    else:
        assert chunks == [(0, 0)]
    if name == "7b" and offset == 8545:
        assert n * args.num_key_value_heads == plan.grid


def _c_fields(src: str) -> list:
    """(name, kind, count) of each field of `FusedDecodeArgs` in the kernel
    source: kind p (pointer), i (int) or f (float)."""
    body = src[src.index("struct FusedDecodeArgs {"):]
    body = body[body.index("{") + 1:body.index("};")]
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        kind = "p" if "*" in decl else "f" if decl.startswith("float") else "i"
        names = re.sub(r"^(const )?(void\*|int|float)", "", decl)
        for n in names.split(","):
            m = re.fullmatch(r"\s*\*?\s*(\w+)(?:\[(\d+)\])?\s*", n)
            fields.append((m.group(1), kind, int(m.group(2) or 1)))
    return fields


def test_plan_barriers_and_kernel_constants():
    """A step takes 5 grid barriers a layer (at most 5 L + 2): the plan
    says so and the kernel's layer loop holds exactly that many; the plan's
    mirrors of the kernel's constants and of `FusedDecodeArgs` agree with
    csrc/fused_decode.cu."""
    args, L, n2p = _plan_model("7b")
    plan = fd.fused_decode_plan(
        args, fd.FusedDecodeShapes(L, 64, n2p, args.vocab_size), 132)
    assert plan.barriers == fd.BARRIERS_PER_LAYER * L <= 5 * L + 2
    src = KERNEL_SOURCE.read_text()
    loop = src[src.index("run_phase(c, P_QKV, l);"):]
    loop = loop[:loop.index("if (a.has_head) run_phase")]
    assert loop.count("grid_barrier(") == fd.BARRIERS_PER_LAYER
    assert src.count("grid_barrier(bar") == fd.BARRIERS_PER_LAYER
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))

    def value(name):
        return eval(consts[name], {}, {k: value(k) for k in consts
                                       if re.search(rf"\b{k}\b",
                                                    consts[name])})

    for name, want in (("BK", fd.BK), ("STRIP", fd.STRIP),
                       ("Q_BYTES", fd.Q_BYTES), ("SLOT_BYTES", fd.SLOT_BYTES),
                       ("MAX_STAGES", fd.MAX_STAGES), ("T_TILE", fd.T_TILE),
                       ("MAX_GQ", fd.MAX_GQ), ("HD", fd.HEAD_DIM),
                       ("ATT_SCRATCH", fd.ATT_SCRATCH),
                       ("MAX_CHUNKS", fd.MAX_CHUNKS)):
        assert value(name) == want, name
    mirror = []
    for name, ctype in fd._Args._fields_:
        base = ctype._type_ if hasattr(ctype, "_length_") else ctype
        kind = ("p" if base is ctypes.c_void_p else
                "f" if base is ctypes.c_float else "i")
        mirror.append((name, kind, getattr(ctype, "_length_", 1)))
    assert _c_fields(src) == mirror


def test_params_from_pack_equal_keep_layers_load():
    """A pack-only JAX tree (the default) gives the port the same stacked
    per-linear tensors, bit for bit, as a MLX_VLM_TPU_KEEP_LAYERS=1 load,
    which keeps the per-linear copies beside the pack."""
    _, packed, _ = _models(3, seed=5)
    jm, kept, _ = _models(3, seed=5, MLX_VLM_TPU_KEEP_LAYERS="1")
    lp = jm.params["language_model"]
    assert "fused_decode" in lp and "layers" in lp["model"]
    a = packed.params["language_model"]["model"]["layers"]
    b = kept.params["language_model"]["model"]["layers"]
    assert "fused_decode" not in packed.params["language_model"]

    def walk(x, y, path):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y), path
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, Int4GroupedTensor):
            assert (x.n, x.group_size, x.out_dtype) == (
                y.n, y.group_size, y.out_dtype), path
            for f in ("qp", "sl", "sh", "bl", "bh"):
                u, w = getattr(x, f), getattr(y, f)
                assert u.dtype == w.dtype and torch.equal(u, w), f"{path}.{f}"
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), path

    walk(a, b, "layers")


def _greedy(model, stream, n=6):
    prompt = [int(t) for t in np.random.default_rng(6).integers(0, 256, 21)]
    res = list(stream(model, ByteTokenizer(), prompt, max_tokens=n,
                      prefill_step_size=64))
    return [r.token for r in res], np.array(
        [float(np.asarray(r.logprobs).reshape(-1)[0]) for r in res])


def test_greedy_generate_on_fused_route_matches_jax_default_route(
        models, monkeypatch):
    jm, tm, _ = models
    calls = []
    step = language_mod.fused_decode_step
    monkeypatch.setattr(language_mod, "fused_decode_step",
                        lambda *a: calls.append(1) or step(*a))
    before = dict(fd.launches)
    jt, jl = _greedy(jm, jax_stream)
    tt, tl = _greedy(tm, stream_generate)
    assert tt == jt
    np.testing.assert_allclose(tl, jl, atol=0.08)
    assert len(calls) == len(tt) - 1  # every decode step took the route
    assert fd.launches == before      # CPU tensors never launch the kernel


def _route_calls(tm, B, S, monkeypatch):
    calls = []
    step = language_mod.fused_decode_step
    monkeypatch.setattr(language_mod, "fused_decode_step",
                        lambda *a: calls.append(1) or step(*a))
    lm = tm.language_model
    lp = tm.params["language_model"]
    cache = lm.init_cache(B, C, torch.float32)
    emb = lm.embed(lp, torch.arange(B * S).view(B, S) % 250)
    pos = torch.arange(S).view(1, 1, S).expand(3, B, S)
    logits = lm.step_logits(lp, emb, cache, pos)
    assert logits.shape == (B, S, 256) and int(cache.offset) == S
    assert bool(torch.isfinite(logits).all())
    return len(calls)


@pytest.mark.parametrize("B,S,route", [(1, 1, True), (1, 4, False),
                                       (2, 1, False)])
def test_route_takes_fused_branch_only_for_one_token(models, monkeypatch, B,
                                                     S, route):
    _, tm, _ = models
    before = dict(fd.launches)
    assert _route_calls(tm, B, S, monkeypatch) == int(route)
    assert fd.launches == before


def test_route_switch_off(monkeypatch):
    jm, tm, _ = _models(2, seed=13, MLX_VLM_TPU_FUSED_DECODE="0")
    assert "fused_decode" not in jm.params["language_model"]
    monkeypatch.setenv("MLX_VLM_TPU_FUSED_DECODE", "0")
    assert not decide_fused_decode(tm)
    assert _route_calls(tm, 1, 1, monkeypatch) == 0
    monkeypatch.setenv("MLX_VLM_TPU_FUSED_DECODE", "1")
    assert decide_fused_decode(tm)


def test_route_rule_takes_the_kernels_limits_on_the_card(models):
    """On the card the fused route needs what K3 takes (head_dim 128 among
    others), as the reference builds no pack on its device otherwise; on
    the CPU the rule stays the reference's.  This model has head_dim 32:
    eligible on the CPU, per-linear on the card."""
    _, tm, cfg = models
    lp, args = tm.params["language_model"], tm.language_model.args
    assert args.hidden_size // args.num_attention_heads == 32
    assert fd.fused_decode_eligible(lp, args, torch.device("cpu"))
    assert not fd.fused_decode_eligible(lp, args, torch.device("cuda"))
    assert fd.kernel_refusal(args, 64, cfg["intermediate_size"])
    try:
        tm.device = torch.device("cuda")
        assert not decide_fused_decode(tm)
    finally:
        tm.device = torch.device("cpu")
        assert decide_fused_decode(tm)
    # a head_dim-128 model within the kernel's limits keeps the route
    wide = dataclasses.replace(args, hidden_size=256, num_attention_heads=2,
                               num_key_value_heads=1)
    assert fd.kernel_refusal(wide, 64, 256) is None
    for bad in (dict(num_key_value_heads=2, num_attention_heads=1),
                dict(hidden_size=2304, num_attention_heads=18,
                     num_key_value_heads=2)):
        assert fd.kernel_refusal(dataclasses.replace(wide, **bad), 64, 256)
    assert fd.kernel_refusal(wide, 24, 256) and fd.kernel_refusal(wide, 64, 192)


def test_step_logits_match_per_linear_path(models):
    """The fused step and the per-linear path on one token: same cache
    cursor and rows, logits within the z2-vs-dequant rounding."""
    _, tm, _ = models
    lm = tm.language_model
    lp = tm.params["language_model"]
    emb = lm.embed(lp, torch.tensor([[7]]))
    pos = torch.full((3, 1, 1), 3)
    out = []
    for fused in (True, False):
        lm.fused_decode = fused
        cache = lm.init_cache(1, C, torch.float32)
        cache.offset.fill_(3)
        out.append((lm.step_logits(lp, emb, cache, pos), cache))
    lm.fused_decode = True
    (lf, cf), (lr, cr) = out
    assert int(cf.offset) == int(cr.offset) == 4
    np.testing.assert_allclose(cf.k.numpy(), cr.k.numpy(), atol=0.05)
    np.testing.assert_allclose(lf.numpy(), lr.float().numpy(), atol=0.08)


# ----------------------------------------------------------- on a GPU only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 100, 300, 64])
def test_cuda_fused_decode_matches_plain(cuda_device, offset):
    """K3 against its plain version on the card at head_dim 128 (bf16
    model, garbage past `offset`; 64 ends exactly on an attention tile).
    The first layer's k/v rows agree within 1e-4 * max|ref| (summation
    order only); the other outputs within 6e-2 * max|ref|: the kernel also
    rounds attention probabilities to bf16 against a running maximum, and a
    last-bit difference can flip a bf16 rounding of x before a weight dot,
    which the layers amplify.  The kernel reads its cursor from the cache's
    device word.  A second call is bit-identical (sums in a fixed
    order)."""
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.testing import (mlx_int4_checkpoint,
                                                 tiny_qwen2_vl_config)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_qwen2_vl_config(hidden_size=512, intermediate_size=1024,
                               num_attention_heads=4, num_key_value_heads=2,
                               num_hidden_layers=2, vocab_size=1024)
    cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [16, 24, 24]}
    cfg, w = mlx_int4_checkpoint(cfg, seed=3)
    model = load_model_from_weights(cfg, w, torch.bfloat16, "cuda")
    lm = model.language_model
    lp = model.params["language_model"]
    assert lm.fused_decode and fd.fused_head(lp, lm.args) is not None
    g = torch.Generator().manual_seed(0)
    cache = lm.init_cache(1, 512, torch.bfloat16, device=cuda_device)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g))
    cache.k[:, :, :, offset:] = 1e3
    cache.v[:, :, :, offset:] = 1e3
    h = torch.randn((1, 1, 512), generator=g).to(cuda_device, torch.bfloat16)
    cos, sin = lm.rope.cos_sin(torch.full((3, 1, 1), offset,
                                          device=cuda_device))
    kc, vc = cache.k.clone(), cache.v.clone()
    n0 = fd.launches["fused_decode"]
    cache.offset.fill_(offset)
    got = fd.fused_decode_step(lp, lm.args, h, cos[0, 0], sin[0, 0], cache.k,
                               cache.v, cache.offset)
    ref = fd.fused_decode_step_plain(lp, lm.args, h, cos[0, 0], sin[0, 0],
                                     kc, vc, offset)
    torch.cuda.synchronize()
    assert fd.launches["fused_decode"] == n0 + 1 and len(got) == 4
    pairs = [(got[1][0], ref[1][0], 1e-4), (got[2][0], ref[2][0], 1e-4),
             (got[0], ref[0], 6e-2), (got[1][1:], ref[1][1:], 6e-2),
             (got[2][1:], ref[2][1:], 6e-2), (got[3], ref[3], 6e-2),
             (cache.k[:, :, :, offset].float(), kc[:, :, :, offset].float(),
              6e-2)]
    for a, b, rel in pairs:
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())
    assert bool((cache.k[:, :, :, offset + 1:] == 1e3).all())
    assert bool((cache.v[:, :, :, offset + 1:] == 1e3).all())
    again = fd.fused_decode_step(lp, lm.args, h, cos[0, 0], sin[0, 0],
                                 cache.k, cache.v, cache.offset)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
