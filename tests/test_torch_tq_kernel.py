"""The arithmetic and the plan of K7 / K8's CUDA kernel, on the CPU.

csrc/tq_kv_attention.cu runs only on a GPU.  Here a plain emulation of its
arithmetic in f32, with its rounding points, is held to the JAX package's
Pallas kernels in interpret mode: the query and the decoded codes in bf16,
k-steps and value m-tiles laid over the bit planes by the kernel's slot
maps (`key_dim`, `value_dim`, zero past a segment's last byte, so an 8-dim
segment pads its k-step), 8-bit codes as raw bytes, each split's softmax
against its own maximum with bf16(p * vs) (a row's splits cover its history
up to its cursor), and the live splits combined in split order.  The plan `tq_kv_attention_plan` is checked at requests (d)'s
and (e)'s shapes and against the kernel source's constants.  Inputs come
from numpy with a seed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlx_vlm_tpu.core import turboquant as jtq
from mlx_vlm_tpu.ops import tq_kv_attention as jk
from mlx_vlm_tpu_torch.core import turboquant as ttq
from mlx_vlm_tpu_torch.ops import tq_kv_attention as tk

from test_torch_kv_quant import BH, C, G, PALLAS, pad_rows
from test_torch_turboquant import _cursors, split_inputs, tq_inputs

torch.set_num_threads(2)

KERNEL_SOURCE = (Path(tk.__file__).resolve().parent.parent / "csrc"
                 / "tq_kv_attention.cu")

# bf16(p * vs) rounded against a split's own maximum instead of one maximum
# over the Pallas kernel's 256-column tile: each of those roundings may move
# by up to half a bf16 ulp (2^-9 relative), 2.1e-3 * max|ref| at most over
# these cases, so the splits are held at 2^-8 * max|ref|.  With one split
# (T = C) nothing but the order of f32 sums differs: PALLAS holds.
SPLIT_ROUNDING = 2.0 ** -8


def key_dim(g, bits: int, d: int, step: int, slot: int) -> int:
    """Dim (within its segment) of slot 4 tig + e of key k-step `step`, or
    -1 for a pad slot: csrc/tq_kv_attention.cu's `key_dim`."""
    if bits == 8:
        dim = step * tk.TILE + slot
        return dim if dim < d else -1
    half = g.nm // 2
    mg, bt = divmod(step, half)
    byte = mg * g.nm + slot % g.nm
    bit = bt * (16 // g.nm) + slot // g.nm
    return bit * g.w + byte if byte < g.w else -1


def value_dim(g, bits: int, d: int, group: int, tile: int,
              gid: int, h: int) -> int:
    """Dim of m-slot gid + 8 h of value tile `tile` of `group`, or -1:
    csrc/tq_kv_attention.cu's `value_dim`."""
    if bits == 8:
        dim = (group * tk.GROUP_TILES + tile) * tk.TILE + 2 * gid + h
        return dim if dim < d else -1
    half = g.nm // 2
    byte = group * g.nm + 2 * (gid % half) + h
    bit = tile * (16 // g.nm) + gid // half
    return bit * g.w + byte if byte < g.w else -1


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _decoded(codes: np.ndarray, bits: int) -> torch.Tensor:
    """Packed codes [BH, C, w] -> bf16(lut[code]) [BH, C, Dseg]."""
    lut = torch.tensor(ttq._levels(bits), dtype=torch.float32)
    return _bf16(lut[ttq.unpack_codes(torch.from_numpy(codes), bits).long()])


def _key_slots(d: int, bits: int) -> torch.Tensor:
    """The segment dim of every (k-step, slot) of the kernel's key tiles;
    d for a pad slot (which reads a zero)."""
    g = tk.seg_geometry(d, bits)
    dims = [key_dim(g, bits, d, st, L) for st in range(g.steps)
            for L in range(16)]
    return torch.tensor([x if x >= 0 else d for x in dims])


def _value_slots(d: int, bits: int) -> list:
    """(m-tile, slot) -> segment dim of the kernel's value m-tiles, pads
    left out."""
    g = tk.seg_geometry(d, bits)
    per = tk.GROUP_TILES if bits == 8 else g.nm // 2
    out = []
    for mt in range(g.steps):
        group, tile = divmod(mt, per)
        for gid in range(8):
            for h in range(2):
                dim = value_dim(g, bits, d, group, tile, gid, h)
                if dim >= 0:
                    out.append(dim)
    return out


def emulate(q, segs, off, lp, scale: float, T: int, NS: int) -> torch.Tensor:
    """The kernel's arithmetic in f32.  q [BH, g, D]; segs: list of
    (kq, ks, vq, vs, dseg, k_bits, v_bits) numpy arrays / ints; off, lp
    [BH]; NS splits of at most T tokens: a row's NS splits cover its
    history [0, min(C, offset)) in whole 16-token tiles."""
    q = _bf16(torch.from_numpy(q))
    BH_, g, D = q.shape
    C_ = segs[0][0].shape[1]
    keys, vals, dim0 = [], [], 0
    for kq, ks, vq, vs, d, kb, vb in segs:
        qs = torch.cat([q[..., dim0:dim0 + d], torch.zeros(BH_, g, 1)], -1)
        kd = _decoded(kq, kb)
        kd = torch.cat([kd, torch.zeros(BH_, C_, 1)], -1)
        idx = _key_slots(d, kb)
        # every k-step sums its 16 slots; pads are zeros on both sides
        keys.append((qs[..., idx], kd[..., idx], torch.from_numpy(ks)))
        slots = _value_slots(d, vb)
        assert sorted(slots) == list(range(d))  # each dim exactly once
        vals.append((_decoded(vq, vb), torch.from_numpy(vs), dim0, d))
        dim0 += d
    out = torch.zeros(BH_, g, D)
    for b in range(BH_):
        end = min(C_, int(off[b]))
        TS = min(T, max(16, -(-end // (16 * NS)) * 16))
        parts = []
        for s0 in range(0, NS * TS, TS):
            lo, hi = max(s0, int(lp[b])), min(s0 + TS, C_, int(off[b]))
            if lo >= hi:
                continue
            t = torch.arange(lo, hi)
            score = None
            for qs, kd, ks in keys:
                x = torch.einsum("gk,tk->gt", qs[b], kd[b, t]) * ks[b, t]
                score = x if score is None else score + x
            score = score * scale
            m = score.amax(-1, keepdim=True)
            p = torch.exp(score - m)
            acc = torch.zeros(g, D)
            for vd, vs, d0, d in vals:
                pv = _bf16(p * vs[b, t])
                acc[:, d0:d0 + d] = pv @ vd[b, t]
            parts.append((m, p.sum(-1, keepdim=True), acc))
        if len(parts) == 1:
            m, l, acc = parts[0]
            out[b] = acc / torch.clamp(l, min=1e-30)
        elif parts:
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            L, A = torch.zeros(g, 1), torch.zeros(g, D)
            for m, l, acc in parts:  # split order
                w = torch.exp(m - M)
                L = L + l * w
                A = A + acc * w
            out[b] = A / torch.clamp(L, min=1e-30)
    return out


def _check(ref, run, segs_shape) -> None:
    """The emulation in one split at PALLAS, then in the plan's splits at
    SPLIT_ROUNDING."""
    scale = np.abs(ref).max()
    np.testing.assert_allclose(run(C, 1), ref, rtol=0, atol=PALLAS * scale)
    plan = tk.tq_kv_attention_plan(BH, G, C, segs_shape)
    assert plan.splits > 1
    np.testing.assert_allclose(run(plan.tokens, plan.splits), ref, rtol=0,
                               atol=SPLIT_ROUNDING * scale)


@pytest.mark.parametrize("k_bits,v_bits", [(3, 4), (3, 3), (5, 5), (6, 6)])
@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_k7_emulation_matches_pallas(k_bits, v_bits, rows):
    """Tolerances PALLAS and SPLIT_ROUNDING (_check).  The scalar cursor's
    left_pad 20 lies inside a 16-token split; per-row cursors include a
    row that sees nothing (it gets 0)."""
    D = 128
    q, kq, ks, vq, vs = tq_inputs(D, k_bits, v_bits,
                                  seed=100 + k_bits * 10 + v_bits)
    off, lp = _cursors(rows)
    offs = np.broadcast_to(off, (BH,))
    kl, vl = jtq._levels(k_bits), jtq._levels(v_bits)
    ref = np.asarray(jk.tq_kv_decode_attention(
        jnp.asarray(pad_rows(q)), jnp.asarray(kq), jnp.asarray(ks),
        jnp.asarray(vq), jnp.asarray(vs), jnp.asarray(off), D ** -0.5,
        k_bits, v_bits, kl, vl, left_pad=jnp.asarray(lp),
        interpret=True))[:, :G]
    def run(T, NS):
        got = emulate(q, [(kq, ks, vq, vs, D, k_bits, v_bits)], offs, lp,
                      D ** -0.5, T, NS).numpy()
        if rows == "per_row":
            assert not got[2].any()  # row 2 sees nothing
        return got

    _check(ref, run, [(D, k_bits, v_bits)])


@pytest.mark.parametrize("kv_bits", [3.5, 4.5, 3.05, 3.95])
@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_k8_emulation_matches_pallas(kv_bits, rows):
    """Tolerances as for K7.  kv_bits 3.05 and 3.95 give segments of
    120 + 8 and 8 + 120 dims: the 8-dim segment pads its k-step with zeros
    rather than share it with the other segment."""
    q, arrs, lo, hi = split_inputs(kv_bits, seed=int(kv_bits * 100))
    off, lp = _cursors(rows)
    offs = np.broadcast_to(off, (BH,))
    D = q.shape[-1]
    ref = np.asarray(jk.tq_kv_decode_attention_split(
        jnp.asarray(pad_rows(q)), *(jnp.asarray(a) for a in arrs),
        jnp.asarray(off), D ** -0.5, lo, hi, jtq._levels(lo), jtq._levels(hi),
        left_pad=jnp.asarray(lp), interpret=True))[:, :G]
    kqa, ksa, kqb, ksb, vqa, vsa, vqb, vsb = arrs
    DA = kqa.shape[-1] * 8 // lo
    segs = [(kqa, ksa, vqa, vsa, DA, lo, lo),
            (kqb, ksb, vqb, vsb, D - DA, hi, hi)]
    _check(ref,
           lambda T, NS: emulate(q, segs, offs, lp, D ** -0.5, T, NS).numpy(),
           [(DA, lo, lo), (D - DA, hi, hi)])


def test_k7_emulation_with_splits_sized_by_the_cursor():
    """At a 4096-slot cache the plan cuts 43 splits of up to 96 tokens; a
    row at offset 2000 takes splits of 48, one at 4000 of 96, one at 37 of
    16.  Tolerances as above."""
    D, cap, k_bits, v_bits = 128, 4096, 3, 4
    rng = np.random.default_rng(41)
    q = rng.standard_normal((BH, G, D)).astype(np.float32)
    kq = rng.integers(0, 256, (BH, cap, D * k_bits // 8), dtype=np.uint8)
    vq = rng.integers(0, 256, (BH, cap, D * v_bits // 8), dtype=np.uint8)
    ks, vs = (rng.uniform(0.5, 1.5, (BH, cap)).astype(np.float32)
              for _ in range(2))
    off = np.array([2000, 4000, 37], np.int32)
    lp = np.array([0, 100, 5], np.int32)
    ref = np.asarray(jk.tq_kv_decode_attention(
        jnp.asarray(pad_rows(q)), jnp.asarray(kq), jnp.asarray(ks),
        jnp.asarray(vq), jnp.asarray(vs), jnp.asarray(off), D ** -0.5,
        k_bits, v_bits, jtq._levels(k_bits), jtq._levels(v_bits),
        left_pad=jnp.asarray(lp), interpret=True))[:, :G]
    plan = tk.tq_kv_attention_plan(BH, G, cap, [(D, k_bits, v_bits)])
    assert (plan.tokens, plan.splits) == (96, 43)
    segs = [(kq, ks, vq, vs, D, k_bits, v_bits)]
    scale = np.abs(ref).max()
    for T, NS, tol in ((cap, 1, PALLAS), (plan.tokens, plan.splits,
                                          SPLIT_ROUNDING)):
        got = emulate(q, segs, off, lp, D ** -0.5, T, NS).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def test_8bit_emulation_matches_plain_raw_bytes():
    """8-bit codes are raw bytes (the reference's Pallas kernel reads them
    as bit planes, a known fault, ROADMAP Queue 3), so the emulation is
    held to the port's plain version, which decodes raw bytes and rounds
    against one maximum as the Pallas kernel does; tolerances as for K7."""
    D = 128
    q, kq, ks, vq, vs = tq_inputs(D, 8, 8, seed=88)
    off, lp = _cursors("per_row")
    ref = tk.tq_kv_decode_attention_plain(
        *(torch.from_numpy(a) for a in (q, kq, ks, vq, vs)),
        torch.from_numpy(off), D ** -0.5, 8, 8, ttq._levels(8),
        ttq._levels(8), torch.from_numpy(lp)).numpy()
    _check(ref, lambda T, NS: emulate(q, [(kq, ks, vq, vs, D, 8, 8)], off,
                                      lp, D ** -0.5, T, NS).numpy(),
           [(D, 8, 8)])


@pytest.mark.parametrize("d,bits", [(128, 3), (128, 4), (64, 3), (120, 3),
                                    (8, 4), (96, 5), (16, 2), (128, 8),
                                    (120, 8)])
def test_slot_maps_cover_each_dim_once(d, bits):
    """A k-step's 16 slots and a value m-tile's 16 slots each name
    distinct dims, every dim of the segment exactly once, and a pad slot
    only where a tile passes the segment's last byte."""
    g = tk.seg_geometry(d, bits)
    keys = [key_dim(g, bits, d, st, L) for st in range(g.steps)
            for L in range(16)]
    assert sorted(x for x in keys if x >= 0) == list(range(d))
    assert sorted(_value_slots(d, bits)) == list(range(d))
    if bits != 8:
        # the fewest tiles for w bytes a plane: nm / 2 tiles per group
        assert g.steps == g.nm // 2 * -(-g.w // g.nm)
        assert g.steps == min(n // 2 * -(-g.w // n) for n in (16, 8, 4))
    pads = keys.count(-1)
    assert pads == 16 * g.steps - d


def test_plan_at_requests_d_and_e():
    """(d) kv_bits 3.5 (K7: 3-bit keys, 4-bit values) and (e) kv_bits 3.5
    split (K8: 64 dims at 3 bits, 64 at 4) on Qwen2-VL-7B's 4 KV heads of
    7 query rows over an 8704-slot cache: 32 splits of 272 tokens (one
    block per SM of 132, 128 blocks), 9 warps for 17 tiles (2 each but
    one), 8 combiners, and each block's shared memory."""
    d = tk.tq_kv_attention_plan(4, 7, 8704, [(128, 3, 4)])
    e = tk.tq_kv_attention_plan(4, 7, 8704, [(64, 3, 3), (64, 4, 4)])
    assert d == tk.TqPlan(tokens=272, splits=32, combiners=8, warps=9,
                          n_tiles=1, row_groups=1, smem_bytes=96160)
    assert e == tk.TqPlan(tokens=272, splits=32, combiners=8, warps=9,
                          n_tiles=1, row_groups=1, smem_bytes=105952)
    # the 2B model's 2 KV heads of 6 rows, and 12 rows (two n-tiles)
    two_b = tk.tq_kv_attention_plan(2, 6, 8704, [(128, 3, 4)])
    assert (two_b.tokens, two_b.splits, two_b.warps) == (144, 61, 9)
    wide = tk.tq_kv_attention_plan(4, 12, 8704, [(128, 3, 4)])
    assert (wide.n_tiles, wide.row_groups, wide.warps) == (2, 1, 6)
    assert tk.tq_kv_attention_plan(4, 20, 8704,
                                   [(128, 3, 4)]).row_groups == 2
    for p in (d, e, two_b, wide):
        assert p.splits * p.tokens >= 8704 > (p.splits - 1) * p.tokens
        assert p.smem_bytes <= tk.SMEM_BYTES
        # no more combiners than SMs per (head, row group): the waiting
        # ones can never hold every SM
        assert p.combiners <= 132 // (4 * p.row_groups)


def test_plan_shrinks_splits_to_fit_shared_memory_and_refuses():
    """At 8-bit codes and one KV head a split of MAX_TOKENS tokens does not
    fit: T halves.  Three segments or no row are refused."""
    p = tk.tq_kv_attention_plan(1, 7, 1 << 16, [(256, 8, 8)])
    assert p.tokens < tk.MAX_TOKENS and p.smem_bytes <= tk.SMEM_BYTES
    assert tk._smem_bytes([(256, 8, 8)], 2 * p.tokens, 256, 1,
                          p.warps) > tk.SMEM_BYTES
    with pytest.raises(ValueError):
        tk.tq_kv_attention_plan(4, 7, 8704, [(64, 3, 3)] * 3)
    with pytest.raises(ValueError):
        tk.tq_kv_attention_plan(4, 0, 8704, [(128, 3, 4)])


def test_plan_mirrors_kernel_constants_and_layout():
    """The Python constants equal csrc/tq_kv_attention.cu's, and `tq_layout`
    lays out the regions `_smem_bytes` counts, in its order."""
    src = KERNEL_SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    for name in ("TILE", "MAX_SEGS", "MAX_NT", "MAX_WARPS", "LUT_ENTRIES",
                 "GROUP_TILES", "ARRAY_SLACK", "MAX_COMBINERS"):
        assert int(consts[name]) == getattr(tk, name), name
    layout = src[src.index("inline TqLayout tq_layout("):]
    layout = layout[:layout.index("L.bytes = o;")]
    assert re.findall(r"L\.(\w+)(?:\[g\]\[j\])? = o;", layout) == [
        "lut", "lraw", "qraw", "qf", "S", "pv", "ml", "part", "red", "arr"]
    # the kernel checks the plan's bytes against its own layout
    assert "tq_layout(dd, kb, vb, nseg, T, a.D, nt, warps).bytes != smem" \
        in src
    assert "tq_split_kernel" not in src and "combine_kernel" not in src


def test_launch_refuses_cpu_tensors():
    """The kernel path takes CUDA tensors only; the public wrappers send
    CPU tensors to the plain versions before it."""
    q, kq, ks, vq, vs = (torch.from_numpy(a)
                         for a in tq_inputs(128, 3, 4, seed=2))
    with pytest.raises(TypeError):
        tk._launch("tq_kv_decode_attention", q,
                   [(kq, ks, vq, vs, ttq._levels(3), ttq._levels(4), 128, 3,
                     4)], torch.zeros(BH, dtype=torch.int32),
                   torch.zeros(BH, dtype=torch.int32), 0.1)
