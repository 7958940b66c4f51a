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
  :1085);
- RoPE uses the duplicated-half convention (`_rope_rows` :575) and q is
  scaled by hd**-0.5 after it;
- attention rounds q, the history k/v and the probabilities to bf16 for
  the two history dots, keeps the current token's score and value in f32,
  and reads history [0, offset) only (:826-851; left_pad is not read);
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

`fused_decode_step` writes the step's k/v rows into the cache at `offset`
(in place, in the model's cache dtype) and returns the f32 rows as well;
the step's own attention uses the f32 rows.  On CPU tensors it runs
`fused_decode_step_plain`; on CUDA tensors it launches the kernel or
raises.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.quant import Int4GroupedTensor
from . import _cuda

launches = {"fused_decode": 0}

LINEARS = (("self_attn", "q_proj"), ("self_attn", "k_proj"),
           ("self_attn", "v_proj"), ("self_attn", "o_proj"),
           ("mlp", "gate_proj"), ("mlp", "up_proj"), ("mlp", "down_proj"))
HEAD_DIM = 128  # the kernel's head size


def _linears(params: dict):
    layers = params["model"]["layers"]
    return [layers[a][b] for a, b in LINEARS]


def kernel_refusal(args, group_size: int, intermediate: int):
    """Why the CUDA kernel cannot take a model, or None: it takes head_dim
    HEAD_DIM, at most 8 q heads per kv head, g % 16 == 0 and hidden and
    intermediate sizes that are multiples of KS_NARROW."""
    D, nh, nkv = (args.hidden_size, args.num_attention_heads,
                  args.num_key_value_heads)
    if D // nh != HEAD_DIM or nh % nkv or nh // nkv > 8:
        return (f"the kernel takes head_dim {HEAD_DIM} and at most 8 q heads "
                "per kv head")
    if group_size % 16 or D % KS_NARROW or intermediate % KS_NARROW:
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
    its device for a head_dim the kernel does not take (:205-210)."""
    try:
        ws = [p["weight"] for p in _linears(params)]
    except (KeyError, TypeError):
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
                            offset: int):
    """Plain PyTorch version of K3 (the reference's TPU-route math).

    h [1, 1, D]; cos/sin [hd/2] f32; k/v_cache [L, 1, Hkv, C, hd], written
    in place at `offset`.  Returns (h_out [1, 1, D] f32 before the final
    norm, k_new [L, Hkv*hd] f32, v_new [L, Hkv*hd] f32) and, when the head
    is fused, logits [1, V] f32."""
    mp = params["model"]
    layers = mp["layers"]
    lin = _linears(params)
    D, eps = args.hidden_size, args.rms_norm_eps
    nh, nkv = args.num_attention_heads, args.num_key_value_heads
    hd = D // nh
    gq = nh // nkv
    L = lin[0]["weight"].qp.shape[0]
    dev = h.device
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
        kh = k_cache[l, 0, :, :offset].to(torch.bfloat16).float()
        vh = v_cache[l, 0, :, :offset].to(torch.bfloat16).float()
        k_cache[l, 0, :, offset] = k.to(k_cache.dtype)
        v_cache[l, 0, :, offset] = v.to(v_cache.dtype)
        outs = []
        for a in range(nkv):
            qg = q[a * gq:(a + 1) * gq]                          # [gq, hd]
            s_hist = qg.to(torch.bfloat16).float() @ kh[a].T     # [gq, off]
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


# ------------------------------------------------------------ the kernel

KS_NARROW, KS_WIDE = 128, 512  # K rows per work unit (32 lanes x 4 / x 16)


def _slice_rows(K: int) -> int:
    return KS_WIDE if K % KS_WIDE == 0 else KS_NARROW


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
        ("part_a", ctypes.c_void_p), ("part_b", ctypes.c_void_p),
        ("qbuf", ctypes.c_void_p), ("attn_ml", ctypes.c_void_p),
        ("attn_acc", ctypes.c_void_p),
        ("n2p", ctypes.c_int * 8),
        ("ks", ctypes.c_int * 5),  # qkv, o, gate|up, down, head
        ("L", ctypes.c_int), ("D", ctypes.c_int), ("I", ctypes.c_int),
        ("n_heads", ctypes.c_int), ("n_kv", ctypes.c_int),
        ("group_size", ctypes.c_int), ("capacity", ctypes.c_int),
        ("offset", ctypes.c_int), ("vocab", ctypes.c_int),
        ("has_head", ctypes.c_int), ("small_bf16", ctypes.c_int),
        ("max_chunks", ctypes.c_int),
        ("eps", ctypes.c_float), ("scale", ctypes.c_float),
    ]


def _check_int4(w: Int4GroupedTensor, dev, name: str) -> None:
    for a in (w.qp, w.sl, w.sh, w.bl, w.bh):
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"fused_decode: {name} must be contiguous on {dev}")
    if w.qp.dtype != torch.uint8 or any(
            a.dtype != torch.float32 for a in (w.sl, w.sh, w.bl, w.bh)):
        raise TypeError(f"fused_decode: {name} needs uint8 codes, f32 planes")
    if w.qp.shape[-1] % 128:
        raise ValueError(f"fused_decode: {name} N2p must be a multiple of 128")


def _small(t: torch.Tensor, dtype, dev, name: str) -> int:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"fused_decode: {name} must be contiguous {dtype} "
                         f"on {dev}")
    return t.data_ptr()


def fused_decode_step(params: dict, args, h: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, offset: int):
    """K3: one whole-stack decode step (contract of
    `fused_decode_step_plain`).  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
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
                or tuple(c.shape) != shape or not c.is_contiguous()):
            raise ValueError(f"fused_decode: {name} must be contiguous "
                             f"bfloat16 {shape} on {dev}")
    C = shape[3]
    if not 0 <= offset < C:
        raise ValueError(f"fused_decode: offset {offset} outside [0, {C})")
    if tuple(h.shape) != (1, 1, D):
        raise ValueError(f"fused_decode: h must be [1, 1, {D}]")

    a = _Args()
    for i, w in enumerate(ws + ([head] if head is not None else [])):
        _check_int4(w, dev, f"{LINEARS[i][1] if i < 7 else 'lm_head'}")
        for j, f in enumerate((w.qp, w.sl, w.sh, w.bl, w.bh)):
            a.w[5 * i + j] = f.data_ptr()
        a.n2p[i] = w.qp.shape[-1]
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

    n2p = [w.qp.shape[-1] for w in ws]
    ks = [KS_NARROW, KS_NARROW, _slice_rows(D), _slice_rows(I),
          _slice_rows(D)]
    rows_a = [D // ks[0] * 2 * sum(n2p[:3]), D // ks[2] * 2 * (n2p[4] + n2p[5])]
    rows_b = [D // ks[1] * 2 * n2p[3], I // ks[3] * 2 * n2p[6]]
    h_out = torch.empty((1, 1, D), dtype=torch.float32, device=dev)
    k_new = torch.empty((L, nkv * hd), dtype=torch.float32, device=dev)
    v_new = torch.empty_like(k_new)
    logits = None
    if head is not None:
        a.final_norm = _small(params["model"]["norm"]["weight"], small_dt,
                              dev, "norm")
        rows_a.append(D // ks[4] * 2 * head.qp.shape[-1])
        logits = torch.empty((1, head.n), dtype=torch.float32, device=dev)
        a.logits, a.vocab, a.has_head = logits.data_ptr(), head.n, 1
    lib = _cuda.library()
    max_chunks = lib.mvt_fused_decode_grid()
    if max_chunks <= 0:
        raise RuntimeError("fused_decode: the kernel cannot be resident")
    part_a = torch.empty(max(rows_a), dtype=torch.float32, device=dev)
    part_b = torch.empty(max(rows_b), dtype=torch.float32, device=dev)
    qbuf = torch.empty(D, dtype=torch.float32, device=dev)
    attn_ml = torch.empty((nh, max_chunks, 2), dtype=torch.float32,
                          device=dev)
    attn_acc = torch.empty((nh, max_chunks, hd), dtype=torch.float32,
                           device=dev)
    a.h_out, a.k_new, a.v_new = (t.data_ptr() for t in (h_out, k_new, v_new))
    a.part_a, a.part_b, a.qbuf = (t.data_ptr() for t in (part_a, part_b, qbuf))
    a.attn_ml, a.attn_acc = attn_ml.data_ptr(), attn_acc.data_ptr()
    for i, v in enumerate(ks):
        a.ks[i] = v
    a.L, a.D, a.I, a.n_heads, a.n_kv = L, D, I, nh, nkv
    a.group_size, a.capacity, a.offset = g, C, offset
    a.small_bf16 = int(small_dt == torch.bfloat16)
    a.max_chunks = max_chunks
    a.eps, a.scale = eps, hd**-0.5
    err = lib.mvt_fused_decode(ctypes.addressof(a), _cuda.stream_handle(dev))
    _cuda.check(err, "fused_decode")
    launches["fused_decode"] += 1
    if head is None:
        return h_out, k_new, v_new
    return h_out, k_new, v_new, logits
