"""Whole-stack fused int4 decode step: one kernel for all L layers (K3).

Port of mlx_vlm_tpu/ops/fused_decode.py.  The reference has two Pallas
versions of one decode step at B=1, S=1: `fused_decode_step` (:1355, the
pipelined grid with `_mv2` dequant math, its CPU route) and
`fused_decode_step_manual` (:964, the manual-DMA kernel with `_mv2z` "z2"
math and an optional fused lm_head, its TPU route).  One CUDA kernel
written for Hopper takes the place of both (csrc/fused_decode.cu); it
follows the TPU route's math:

- every weight dot rounds x to bf16 and takes, per quantization group, the
  dot with the raw code bytes (lo + 16 * hi) and with the high nibble; the
  scales s_l, s_h and biases b_l, b_h apply to the f32 group partials, the
  bias term with the unrounded f32 sum of x over the group (`_mv2z`
  :1085).  The kernel sums the low plane directly, as exact bf16 codes
  128 + q on the tensor cores, and folds each group as
  s (sum x_b (128 + q) - 128 sum x_b) + b sum x_f32: the same sums up to
  f32 reassociation;
- RoPE uses the duplicated-half convention (`_rope_rows` :575) and q is
  scaled by hd**-0.5 after it;
- attention rounds q, the history k/v and the probabilities to bf16 for
  the two history dots, keeps the current token's score and value in f32,
  and reads history [0, offset) only (:826-851; left_pad is not read):
  whatever the cache holds past the cursor, NaN included, stays out of
  every sum;
- the residual stream stays f32 across all layers of the step;
- the fused head normalises the f32 h with the final norm (:925-959) and
  returns logits in vocab order.

Not ported: the tile-major pack and its inverse (`build_fused_pack`
:169-368, `pack_scan_tree` / `layer_params_from_pack` :381-475), which are
TPU residency artifacts.  The kernel reads the port's stacked per-linear
weights, halves-packed qp [L, K, N2p] and f32 planes [L, G, 1, N2p], the
same tensors K1 and K2 read, so the port keeps one copy of the weights.
Also not ported: M_ROWS row padding, nh8 / nkv8, `_scales_f32` (u16
planes), `_mv2` (the deq switch), FUSED_DECODE_TILES, FUSED_DECODE_CHUNK_K,
FUSED_DECODE_ABLATE, MLX_VLM_TPU_PACK_SC16 / SCB16, MLX_VLM_TPU_FUSED_MV
and MLX_VLM_TPU_FUSED_V3.

The kernel takes its numbers from `fused_decode_plan`: the grid (one block
per SM), each phase's K slices and which block streams which weight tile,
the weight ring's stages and shared memory, the most attention chunks and
the barrier count (5 per layer); the CPU tests check the plan that the card
runs.  The plan does not depend on the step: the cursor `offset` is a
device word (the cache's int32 0-dim cursor) that the kernel reads, and it
derives the step's attention chunks from it by `FusedDecodePlan.chunks_at`,
so one launch captured in a CUDA graph serves every step (its outputs and
scratch, allocated per call, then lie in the graph's own memory pool and
keep their addresses at every replay).  The card's SMs and the kernel's
residency are queried once per card.

`fused_decode_step` writes the step's k/v rows into the cache at `offset`
(in place, in the model's cache dtype) and returns the f32 rows as well;
the step's own attention uses the f32 rows.  On CPU tensors it runs
`fused_decode_step_plain`; on CUDA tensors it launches the kernel or
raises.  `launches` counts kernel launches that execute (a launch captured
in a CUDA graph counts at each replay, ops/_cuda.py `count`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
import math
from typing import Union

import torch

from ..core.quant import Int4GroupedTensor
from . import _cuda

launches = {"fused_decode": 0}

LINEARS = (("self_attn", "q_proj"), ("self_attn", "k_proj"),
           ("self_attn", "v_proj"), ("self_attn", "o_proj"),
           ("mlp", "gate_proj"), ("mlp", "up_proj"), ("mlp", "down_proj"))
HEAD_DIM = 128  # the kernel's head size
MAX_GQ = 8  # the kernel's q heads per kv head


def _linears(params: dict):
    layers = params["model"]["layers"]
    return [layers[a][b] for a, b in LINEARS]


def kernel_refusal(args, group_size: int, intermediate: int):
    """Why the CUDA kernel cannot take a model, or None: it takes head_dim
    HEAD_DIM, at most 8 q heads per kv head, g % 16 == 0 and hidden and
    intermediate sizes that are multiples of STRIP."""
    D, nh, nkv = (args.hidden_size, args.num_attention_heads,
                  args.num_key_value_heads)
    if D // nh != HEAD_DIM or nh % nkv or nh // nkv > MAX_GQ:
        return (f"the kernel takes head_dim {HEAD_DIM} and at most {MAX_GQ} "
                "q heads per kv head")
    if group_size % 16 or D % STRIP or intermediate % STRIP:
        return ("needs group_size % 16 == 0 and hidden, intermediate "
                "multiples of 128")
    return None


def fused_decode_eligible(params: dict, args, device="cpu") -> bool:
    """The reference's rules for building a pack (`build_fused_pack`
    :187-211): all seven layer linears are stacked Int4GroupedTensor with
    one group size, K % g == 0, I % g == 0, K == D, n_heads * head_dim == D
    and each linear's n matches.  `params` is the language model's tree.
    On a `device` other than the CPU the step runs the kernel, so its
    limits (`kernel_refusal`) apply too, as the reference builds no pack on
    its device for a head_dim the kernel does not take (:205-210).  A
    tree that carries LoRA / DoRA factors (trainer/lora.py) is refused:
    the kernel reads the base weights alone, where the reference keeps its
    pack and decodes without the adapter (ROADMAP Queue 3, known
    faults)."""
    try:
        ws = [p["weight"] for p in _linears(params)]
    except (KeyError, TypeError):
        return False
    from ..trainer.lora import has_adapters

    if has_adapters(params):
        logging.getLogger("mlx_vlm_tpu_torch.loader").warning(
            "adapter factors attached: the fused decode step (K3) is off, "
            "every step runs the per-linear path")
        return False
    if not all(isinstance(w, Int4GroupedTensor) and w.qp.dim() == 3
               for w in ws):
        return False
    if len({w.group_size for w in ws}) != 1:
        return False
    wq, wk, wv, wo, wg, wu, wd = ws
    g = wq.group_size
    D = args.hidden_size
    K, I = wq.qp.shape[1], wd.qp.shape[1]
    nh, nkv = args.num_attention_heads, args.num_key_value_heads
    if K % g or I % g or K != D or nh * (D // nh) != D:
        return False
    n_kv = nkv * (D // nh)
    if not (wq.n == D and wo.n == D and wd.n == D and wg.n == I
            and wu.n == I and wk.n == n_kv and wv.n == n_kv
            and all(w.qp.shape[1] == D for w in (wk, wv, wo, wg, wu))):
        return False
    return (torch.device(device).type == "cpu"
            or kernel_refusal(args, g, I) is None)


def fused_head(params: dict, args):
    """The lm_head weight when the step fuses the head (reference :315-320:
    a 2-D int4 [D, .] weight with the layers' group size, embeddings not
    tied), else None."""
    if getattr(args, "tie_word_embeddings", False):
        return None
    w = (params.get("lm_head") or {}).get("weight")
    g = _linears(params)[0]["weight"].group_size
    if (isinstance(w, Int4GroupedTensor) and w.qp.dim() == 2
            and w.qp.shape[0] == args.hidden_size and w.group_size == g):
        return w
    return None


# ------------------------------------------------------------ plain version


def _mv_z2(x: torch.Tensor, t: Int4GroupedTensor) -> torch.Tensor:
    """x [K] f32 @ dequant(t) -> [n] f32 with `_mv2z`'s rounding points."""
    K, n2p = t.qp.shape
    g = t.group_size
    G = K // g
    qi = t.qp.to(torch.int32).view(G, g, n2p)
    xb = x.to(torch.bfloat16).float().view(G, 1, g)
    z2 = torch.bmm(xb, qi.float())[:, 0]                  # [G, n2p]
    zh = torch.bmm(xb, (qi >> 4).float())[:, 0]
    sj = x.view(G, g).sum(-1, keepdim=True)               # unrounded
    ylo = ((z2 - 16.0 * zh) * t.sl[:, 0] + sj * t.bl[:, 0]).sum(0)
    yhi = (zh * t.sh[:, 0] + sj * t.bh[:, 0]).sum(0)
    return torch.cat([ylo, yhi])[: t.n]


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean() + eps) * w.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [R, hd] f32; cos/sin [hd/2] (duplicated-half convention)."""
    h = x.shape[-1] // 2
    rot = torch.cat([-x[:, h:], x[:, :h]], dim=-1)
    return x * torch.cat([cos, cos]) + rot * torch.cat([sin, sin])


def _bias(p: dict, i: int, n: int, device) -> torch.Tensor:
    b = p.get("bias")
    if b is None:
        return torch.zeros(n, device=device)
    return b[i].float()


def fused_decode_step_plain(params: dict, args, h: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            offset: Union[int, torch.Tensor]):
    """Plain PyTorch version of K3 (the reference's TPU-route math).

    h [1, 1, D]; cos/sin [hd/2] f32; k/v_cache [L, 1, Hkv, C, hd], written
    in place at `offset` (an int or a 0-dim int tensor, which is never read
    on the host: the history is the whole capacity with the columns at or
    past the cursor kept out of both products).  Returns (h_out [1, 1, D]
    f32 before the final norm, k_new [L, Hkv*hd] f32, v_new [L, Hkv*hd]
    f32) and, when the head is fused, logits [1, V] f32."""
    mp = params["model"]
    layers = mp["layers"]
    lin = _linears(params)
    D, eps = args.hidden_size, args.rms_norm_eps
    nh, nkv = args.num_attention_heads, args.num_key_value_heads
    hd = D // nh
    gq = nh // nkv
    L = lin[0]["weight"].qp.shape[0]
    dev = h.device
    C = k_cache.shape[3]
    row = torch.as_tensor(offset, device=dev).long().reshape(1)
    live = torch.arange(C, device=dev) < row  # history columns [0, offset)
    cos, sin = cos.float(), sin.float()
    x = h.reshape(D).float()
    k_new = torch.empty((L, nkv * hd), device=dev)
    v_new = torch.empty((L, nkv * hd), device=dev)
    pq, pk, pv, po, pg, pu, pd = lin
    for l in range(L):
        xn = _rms(x, layers["input_layernorm"]["weight"][l], eps)
        q = _mv_z2(xn, pq["weight"].layer(l)) + _bias(pq, l, D, dev)
        k = _mv_z2(xn, pk["weight"].layer(l)) + _bias(pk, l, nkv * hd, dev)
        v = _mv_z2(xn, pv["weight"].layer(l)) + _bias(pv, l, nkv * hd, dev)
        q = _rope(q.view(nh, hd), cos, sin) * hd**-0.5
        k = _rope(k.view(nkv, hd), cos, sin)
        v = v.view(nkv, hd)
        k_new[l], v_new[l] = k.reshape(-1), v.reshape(-1)
        kh = k_cache[l, 0].to(torch.bfloat16).float()
        vh = torch.where(live[:, None],
                         v_cache[l, 0].to(torch.bfloat16).float(), 0.0)
        k_cache[l, 0].index_copy_(1, row, k[:, None].to(k_cache.dtype))
        v_cache[l, 0].index_copy_(1, row, v[:, None].to(v_cache.dtype))
        outs = []
        for a in range(nkv):
            qg = q[a * gq:(a + 1) * gq]                          # [gq, hd]
            s_hist = torch.where(live, qg.to(torch.bfloat16).float()
                                 @ kh[a].T, float("-inf"))       # [gq, C]
            s_cur = (qg * k[a]).sum(-1, keepdim=True)            # [gq, 1]
            m = torch.cat([s_hist, s_cur], dim=-1).amax(-1, keepdim=True)
            ph = torch.exp(s_hist - m)
            pc = torch.exp(s_cur - m)
            denom = ph.sum(-1, keepdim=True) + pc
            o = ph.to(torch.bfloat16).float() @ vh[a]
            outs.append((o + pc * v[a]) / denom)
        attn = torch.cat(outs).reshape(D)
        x = x + _mv_z2(attn, po["weight"].layer(l))
        xn = _rms(x, layers["post_attention_layernorm"]["weight"][l], eps)
        gate = _mv_z2(xn, pg["weight"].layer(l))
        up = _mv_z2(xn, pu["weight"].layer(l))
        act = gate * torch.sigmoid(gate) * up
        x = x + _mv_z2(act, pd["weight"].layer(l))
    outs = (x.view(1, 1, D), k_new, v_new)
    head = fused_head(params, args)
    if head is None:
        return outs
    xn = _rms(x, mp["norm"]["weight"], eps)
    return outs + (_mv_z2(xn, head)[None],)


# ------------------------------------------------------------ the plan

# Mirrors of csrc/fused_decode.cu's constants: keep both in step.
BK, STRIP = 64, 128           # code rows per ring stage; packed columns a piece
Q_BYTES = BK * STRIP          # codes of one stage
SLOT_BYTES = 4 * STRIP * 4    # one group's four f32 scale planes
MAX_STAGES = 32
T_TILE = 64                   # history tokens per attention tile (4 stages)
# an attention unit's scratch in the x region: the q|k|v rows, the warps'
# (m, l) and O^T
ATT_SCRATCH = ((MAX_GQ + 2) * HEAD_DIM + 4 * (2 + HEAD_DIM) * MAX_GQ) * 4
XROWS = 2048                  # x rows staged at once, at least
MAX_CHUNKS = 160
SMEM_LIMIT = 232448           # shared memory of a block on the H100 (227 KB)
STATIC_BYTES = 8192           # the kernel's static shared memory, at most
PHASES = ("qkv", "o", "gate_up", "down", "head")
PHASE_LINEARS = ((0, 1, 2), (3,), (4, 5), (6,), (7,))  # indices in LINEARS
BARRIERS_PER_LAYER = 5


@dataclasses.dataclass(frozen=True)
class FusedDecodeShapes:
    """What the plan needs of the weights: layers, group size, each
    linear's packed width N2p (q, k, v, o, gate, up, down and, when the
    head is fused, lm_head) and the head's vocab (0: no fused head).  The
    step's cursor is not among them: the kernel reads it on the device."""

    layers: int
    group_size: int
    n2p: tuple
    vocab: int


@dataclasses.dataclass(frozen=True)
class FusedDecodePlan:
    """K3's numbers for one step, as the kernel takes them (`_Args`).

    One block per SM.  A phase (q|k|v, o, gate|up, down, head) is a row of
    strips (128 packed columns of one of its linears, in linear order), each
    of G quantization groups; its strips x G group units are cut into `grid`
    equal contiguous ranges, one per block, and a range's part in one strip
    is a piece.  Each block streams its pieces, layer after layer, through a
    ring of `stages` stages of `stage_bytes`; a strip's pieces leave partial
    rows that its last piece adds in order.  Attention at a cursor of
    `offset` runs `chunks_at(offset)` units per kv head (at most
    `max_chunks`), each a whole number of 64-token tiles of [0, offset):
    the kernel derives them from its cursor word by the same rule."""

    grid: int
    group_size: int
    layers: int
    n2p: tuple
    K: tuple                 # K rows per phase
    pmax: tuple              # pieces a strip has at most, per phase
    slots: int               # scale slots per ring stage
    stage_bytes: int
    stages: int
    xrows: int               # x rows the shared memory holds
    seg_rows: int            # x rows staged at once
    unit_rows: int           # rows a consumer warpgroup takes at a time
    smem_bytes: int          # dynamic shared memory
    max_chunks: int
    n_kv: int
    barriers: int
    part_floats: int         # partial rows of the widest phase
    sync_words: int          # the grid barrier and one ticket per strip

    @property
    def phases(self) -> int:
        return 5 if len(self.n2p) == 8 else 4

    def strips(self, p: int) -> list:
        return [self.n2p[i] // STRIP for i in PHASE_LINEARS[p]]

    def units(self, p: int) -> int:
        return sum(self.strips(p)) * (self.K[p] // self.group_size)

    def blocks(self, p: int) -> int:
        """Blocks that own units of phase p: every one owns at least one."""
        return min(self.grid, self.units(p))

    def owner(self, p: int, u: int) -> int:
        """The block whose range holds group unit u of phase p."""
        nb = self.blocks(p)
        return (u * nb + nb - 1) // self.units(p)

    def pieces_of(self, p: int, strip: int) -> int:
        G = self.K[p] // self.group_size
        return (self.owner(p, strip * G + G - 1) - self.owner(p, strip * G)
                + 1)

    def phase_pieces(self, p: int, block: int) -> list:
        """Block `block`'s pieces of phase p, in order: (linear, first packed
        column, k begin, k end, strip, piece number within the strip)."""
        G, U, g = self.K[p] // self.group_size, self.units(p), self.group_size
        strips, nb = self.strips(p), self.blocks(p)
        b = min(block, nb)
        u, u1 = U * b // nb, U * min(b + 1, nb) // nb
        out = []
        while u < u1:
            strip = u // G
            ue = min(u1, (strip + 1) * G)
            s, lin = strip, 0
            while s >= strips[lin]:
                s -= strips[lin]
                lin += 1
            out.append((PHASE_LINEARS[p][lin], s * STRIP, (u - strip * G) * g,
                        (ue - strip * G) * g, strip,
                        block - self.owner(p, strip * G)))
            u = ue
        return out

    def block_tiles(self, block: int) -> list:
        """Every weight piece block `block` streams in a step, in the order
        its producer loads and its consumers use them: (layer, phase,
        linear, first packed column, k begin, k end)."""
        out = []
        for l in range(self.layers):
            for p in range(4):
                out += [(l, p, *t[:4]) for t in self.phase_pieces(p, block)]
        if self.phases == 5:
            out += [(0, 4, *t[:4]) for t in self.phase_pieces(4, block)]
        return out

    def chunks_at(self, offset: int) -> int:
        """Attention units per kv head at a cursor of `offset`: the
        kernel's min(max_chunks, ceil(offset / T_TILE)), at least 1."""
        return max(1, min(self.max_chunks, -(-offset // T_TILE)))

    def chunk_tokens(self, offset: int) -> list:
        """History tokens [t0, t1) of each attention chunk at `offset`."""
        nsub, chunks = -(-offset // T_TILE), self.chunks_at(offset)
        cuts = [c * nsub // chunks for c in range(chunks + 1)]
        return [(min(a * T_TILE, offset), min(b * T_TILE, offset))
                for a, b in zip(cuts, cuts[1:])]


def _ring(D: int, g: int) -> dict:
    """The shared memory of a block: the x region (x of a K = D phase, a
    norm of h, is staged whole, once per phase) and the ring's stages."""
    unit = BK * g // math.gcd(BK, g)  # stages and groups both end here
    xrows = -(-max(XROWS, D, unit) // 16) * 16
    slots = -(-BK // g)
    stage_bytes = Q_BYTES + slots * SLOT_BYTES
    xbytes = max(xrows * 6 + xrows // 16 * 8, ATT_SCRATCH)
    free = SMEM_LIMIT - STATIC_BYTES - xbytes - 1024
    stages = min(MAX_STAGES, free // stage_bytes)
    if stages < 2:
        raise ValueError(f"fused_decode: group size {g} leaves no room for "
                         "the weight ring")
    return dict(unit_rows=unit, xrows=xrows, seg_rows=xrows // unit * unit,
                slots=slots, stage_bytes=stage_bytes, stages=stages,
                smem_bytes=stages * stage_bytes + xbytes + 1024)


@functools.lru_cache(maxsize=32)
def _plan(D, I, nkv, layers, g, n2p, sm_count) -> dict:
    """`fused_decode_plan`, cached by its arguments."""
    if g <= 0 or g % 16 or D % g or I % g:
        raise ValueError(f"fused_decode: group size {g} does not divide "
                         f"{D} and {I} in multiples of 16")
    if (any(n <= 0 or n % STRIP for n in n2p) or n2p[4] != n2p[5]
            or n2p[3] != n2p[6]):
        raise ValueError("fused_decode: packed widths must be multiples of "
                         f"{STRIP}, gate's equal to up's, o's to down's")
    grid = sm_count
    K = (D, D, D, I, D)[:5 if len(n2p) == 8 else 4]
    pmax, part = [], 0
    for p, k in enumerate(K):
        G = k // g
        strips = sum(n2p[i] for i in PHASE_LINEARS[p]) // STRIP
        U = strips * G
        nb = min(grid, U)
        own = [(u * nb + nb - 1) // U for u in range(U)]
        most = max(own[s * G + G - 1] - own[s * G] + 1
                   for s in range(strips))
        pmax.append(most)
        part = max(part, strips * most * 2 * STRIP)
    return dict(grid=grid, group_size=g, layers=layers, n2p=n2p, K=K,
                pmax=tuple(pmax), **_ring(D, g),
                max_chunks=min(MAX_CHUNKS, max(1, grid // nkv)), n_kv=nkv,
                barriers=BARRIERS_PER_LAYER * layers, part_floats=part,
                sync_words=1 + sum(n2p[i] // STRIP for i in (3, 4, 6, 7)
                                   if i < len(n2p)))


def fused_decode_plan(args, shapes: FusedDecodeShapes,
                      sm_count: int) -> FusedDecodePlan:
    """K3's plan for a model (`args`: hidden size, intermediate size, heads)
    with weights of `shapes` on a card of `sm_count` SMs: the grid, each
    phase's pieces and which block streams each, the ring's stages and its
    shared-memory bytes, the most attention chunks and the barrier count.
    It is the same at every step.  Raises for what the kernel does not
    take."""
    return FusedDecodePlan(**_plan(
        args.hidden_size, args.intermediate_size, args.num_key_value_heads,
        shapes.layers, shapes.group_size, tuple(shapes.n2p), sm_count))


# ------------------------------------------------------------ the kernel


class _Args(ctypes.Structure):
    """Mirror of `FusedDecodeArgs` in csrc/fused_decode.cu."""

    _fields_ = [
        ("w", ctypes.c_void_p * 40),  # 8 linears x (qp, sl, sh, bl, bh)
        ("bias", ctypes.c_void_p * 3),
        ("norm1", ctypes.c_void_p), ("norm2", ctypes.c_void_p),
        ("final_norm", ctypes.c_void_p),
        ("h_in", ctypes.c_void_p), ("cos", ctypes.c_void_p),
        ("sin", ctypes.c_void_p),
        ("k_cache", ctypes.c_void_p), ("v_cache", ctypes.c_void_p),
        ("h_out", ctypes.c_void_p), ("k_new", ctypes.c_void_p),
        ("v_new", ctypes.c_void_p), ("logits", ctypes.c_void_p),
        ("part", ctypes.c_void_p), ("act", ctypes.c_void_p),
        ("attn_ml", ctypes.c_void_p), ("attn_acc", ctypes.c_void_p),
        ("sumsq", ctypes.c_void_p), ("sync", ctypes.c_void_p),
        ("cursor", ctypes.c_void_p),
        ("n2p", ctypes.c_int * 8),
        ("pmax", ctypes.c_int * 5),  # qkv, o, gate|up, down, head
        ("L", ctypes.c_int), ("D", ctypes.c_int), ("I", ctypes.c_int),
        ("n_heads", ctypes.c_int), ("n_kv", ctypes.c_int),
        ("group_size", ctypes.c_int), ("capacity", ctypes.c_int),
        ("vocab", ctypes.c_int),
        ("has_head", ctypes.c_int), ("small_bf16", ctypes.c_int),
        ("grid", ctypes.c_int), ("stages", ctypes.c_int),
        ("slots", ctypes.c_int), ("xrows", ctypes.c_int),
        ("seg_rows", ctypes.c_int), ("unit_rows", ctypes.c_int),
        ("max_chunks", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("eps", ctypes.c_float), ("scale", ctypes.c_float),
    ]


def _check_int4(w: Int4GroupedTensor, dev, name: str) -> None:
    for a in (w.qp, w.sl, w.sh, w.bl, w.bh):
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"fused_decode: {name} must be contiguous on {dev}")
        if a.data_ptr() % 16:
            raise ValueError(f"fused_decode: {name} must be 16-byte aligned "
                             "(the kernel reads it by TMA)")
    if w.qp.dtype != torch.uint8 or any(
            a.dtype != torch.float32 for a in (w.sl, w.sh, w.bl, w.bh)):
        raise TypeError(f"fused_decode: {name} needs uint8 codes, f32 planes")
    if w.qp.shape[-1] % STRIP:
        raise ValueError(f"fused_decode: {name} N2p must be a multiple of "
                         f"{STRIP}")


def _small(t: torch.Tensor, dtype, dev, name: str) -> int:
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"fused_decode: {name} must be contiguous 16-byte "
                         f"aligned {dtype} on {dev}")
    return t.data_ptr()


@functools.lru_cache(maxsize=None)
def _device(index: int, smem_bytes: int) -> int:
    """SMs of card `index`, once it is known that the kernel can be
    resident on every one with `smem_bytes` of shared memory (queried once
    per card and size)."""
    with torch.cuda.device(index):
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        resident = _cuda.library().mvt_fused_decode_grid(smem_bytes)
    if resident < 0:
        _cuda.check(-resident, "fused_decode")
    if resident < sms:
        raise RuntimeError(f"fused_decode: {resident} blocks can be "
                           f"resident, the kernel needs one per SM ({sms})")
    return sms


_SYNC: dict = {}


def _sync_words(dev, n: int) -> torch.Tensor:
    """The card's grid-barrier word and ticket counters: zeroed once, and
    every launch leaves them as it found them."""
    t = _SYNC.get(dev.index)
    if t is None or t.numel() < n:
        t = _SYNC[dev.index] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                           device=dev)
    return t


def step_plan(params: dict, args, device) -> FusedDecodePlan:
    """The plan the kernel runs for every step of this model on a card (its
    SM count and the kernel's residency queried once)."""
    ws = [p["weight"] for p in _linears(params)]
    head = fused_head(params, args)
    full = ws + ([head] if head is not None else [])
    n2p = tuple(w.qp.shape[-1] for w in full)
    L = ws[0].qp.shape[0]
    g = ws[0].group_size
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _device(index, _ring(args.hidden_size, g)["smem_bytes"])
    shapes = FusedDecodeShapes(L, g, n2p, head.n if head is not None else 0)
    return fused_decode_plan(args, shapes, sms)


def fused_decode_step(params: dict, args, h: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      offset: Union[int, torch.Tensor]):
    """K3: one whole-stack decode step (contract of
    `fused_decode_step_plain`).  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise.  On the card `offset` is the
    cache's cursor, an int32 0-dim tensor on the card, which the kernel
    reads when it runs; the caller keeps it in [0, capacity) (the kernel
    traps otherwise)."""
    if h.device.type == "cpu":
        return fused_decode_step_plain(params, args, h, cos, sin, k_cache,
                                       v_cache, offset)
    dev = h.device
    if dev.type != "cuda":
        raise TypeError("fused_decode: the kernel runs on CUDA tensors")
    if not fused_decode_eligible(params, args):
        raise ValueError("fused_decode: the weights are not eligible")
    lin = _linears(params)
    ws = [p["weight"] for p in lin]
    head = fused_head(params, args)
    D, eps = args.hidden_size, args.rms_norm_eps
    nh, nkv = args.num_attention_heads, args.num_key_value_heads
    hd = D // nh
    L, I, _ = ws[6].qp.shape
    g = ws[0].group_size
    refusal = kernel_refusal(args, g, I)
    if refusal:
        raise ValueError(f"fused_decode: {refusal}")
    small_dt = h.dtype
    if small_dt not in (torch.bfloat16, torch.float32):
        raise TypeError("fused_decode: h must be bfloat16 or float32")
    shape = (L, 1, nkv, k_cache.shape[3], hd)
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.device != dev or c.dtype != torch.bfloat16
                or tuple(c.shape) != shape or not c.is_contiguous()
                or c.data_ptr() % 16):
            raise ValueError(f"fused_decode: {name} must be contiguous "
                             f"16-byte aligned bfloat16 {shape} on {dev}")
    C = shape[3]
    if (not isinstance(offset, torch.Tensor) or offset.dtype != torch.int32
            or offset.dim() != 0 or offset.device != dev):
        raise TypeError(f"fused_decode: offset must be an int32 0-dim "
                        f"tensor on {dev} (the cache's cursor)")
    if tuple(h.shape) != (1, 1, D):
        raise ValueError(f"fused_decode: h must be [1, 1, {D}]")

    full = ws + ([head] if head is not None else [])
    n2p = tuple(w.qp.shape[-1] for w in full)
    plan = step_plan(params, args, dev)

    a = _Args()
    for i, w in enumerate(full):
        _check_int4(w, dev, f"{LINEARS[i][1] if i < 7 else 'lm_head'}")
        for j, f in enumerate((w.qp, w.sl, w.sh, w.bl, w.bh)):
            a.w[5 * i + j] = f.data_ptr()
        a.n2p[i] = n2p[i]
    for i in range(3):
        b = lin[i].get("bias")
        a.bias[i] = None if b is None else _small(b, small_dt, dev, "bias")
    layers = params["model"]["layers"]
    a.norm1 = _small(layers["input_layernorm"]["weight"], small_dt, dev,
                     "input_layernorm")
    a.norm2 = _small(layers["post_attention_layernorm"]["weight"], small_dt,
                     dev, "post_attention_layernorm")
    cos = cos.float().contiguous()
    sin = sin.float().contiguous()
    if cos.device != dev or cos.numel() != hd // 2 or sin.numel() != hd // 2:
        raise ValueError(f"fused_decode: cos/sin must be [{hd // 2}] on {dev}")
    a.h_in = _small(h, small_dt, dev, "h")
    a.cos, a.sin = cos.data_ptr(), sin.data_ptr()
    a.k_cache, a.v_cache = k_cache.data_ptr(), v_cache.data_ptr()

    h_out = torch.empty((1, 1, D), dtype=torch.float32, device=dev)
    k_new = torch.empty((L, nkv * hd), dtype=torch.float32, device=dev)
    v_new = torch.empty_like(k_new)
    logits = None
    if head is not None:
        a.final_norm = _small(params["model"]["norm"]["weight"], small_dt,
                              dev, "norm")
        logits = torch.empty((1, head.n), dtype=torch.float32, device=dev)
        a.logits, a.vocab, a.has_head = logits.data_ptr(), head.n, 1
    part = torch.empty(plan.part_floats, dtype=torch.float32, device=dev)
    act = torch.empty(I, dtype=torch.float32, device=dev)
    attn_ml = torch.empty((nh, plan.max_chunks, 2), dtype=torch.float32,
                          device=dev)
    attn_acc = torch.empty((nh, plan.max_chunks, hd), dtype=torch.float32,
                           device=dev)
    a.h_out, a.k_new, a.v_new = (t.data_ptr() for t in (h_out, k_new, v_new))
    a.part, a.act = part.data_ptr(), act.data_ptr()
    sumsq = torch.empty(2 * n2p[3] // STRIP, dtype=torch.float32, device=dev)
    a.attn_ml, a.attn_acc = attn_ml.data_ptr(), attn_acc.data_ptr()
    a.sumsq = sumsq.data_ptr()
    a.sync = _sync_words(dev, plan.sync_words).data_ptr()
    a.cursor = offset.data_ptr()
    for i, v in enumerate(plan.pmax):
        a.pmax[i] = v
    a.L, a.D, a.I, a.n_heads, a.n_kv = L, D, I, nh, nkv
    a.group_size, a.capacity = g, C
    a.small_bf16 = int(small_dt == torch.bfloat16)
    a.grid, a.stages, a.slots = plan.grid, plan.stages, plan.slots
    a.xrows, a.seg_rows, a.unit_rows = plan.xrows, plan.seg_rows, plan.unit_rows
    a.max_chunks = plan.max_chunks
    a.smem_bytes = plan.smem_bytes
    a.eps, a.scale = eps, hd**-0.5
    err = _cuda.library().mvt_fused_decode(ctypes.addressof(a),
                                           _cuda.stream_handle(dev))
    _cuda.check(err, "fused_decode")
    _cuda.count(launches, "fused_decode")
    if head is None:
        return h_out, k_new, v_new
    return h_out, k_new, v_new, logits
