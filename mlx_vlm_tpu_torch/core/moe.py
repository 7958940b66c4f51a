"""Mixture-of-Experts layers (SwitchGLU).

Port of mlx_vlm_tpu/core/moe.py (topk_router :32, switch_mlp :49,
group_expert_select :89, _expert_matmul :111, switch_glu :122).
`switch_glu_dense` and `set_expert_parallel` (:168-239) wait for the port's
parallel/ (ROADMAP Queue 1 item 8).

The layer's function is the reference's: for token n, the sum over its k
chosen experts e = indices[n, j] of weights[n, j] * down_e(act(gate_e(x_n),
up_e(x_n))).  The reference computes it as a masked scan over all E
experts, each seeing every token with routing weight 0 where it was not
chosen; `switch_glu_scan` is that algorithm in torch (`_scan` serves both
layers).
The card's routes compute the chosen experts only.  Both give the same sum
(the unchosen terms are zeros), within rounding: the routes add a token's
k expert outputs in f32 and round once to x's dtype, where the reference
adds them in x's dtype in ascending expert order (:157).

Routes of `switch_glu` and `switch_mlp`, decided by device and shape alone:

- CPU tensors: the masked scan (over the experts some token chose: the
  others add zeros).
- CUDA tensors whose stacks the kernel takes (`experts_kernel_route`, or
  dense tensors):
  * the decode route (`pairs_route`): at most PREFILL_MIN_TOKENS tokens,
    or any count inside a CUDA-graph capture.  Each projection is one
    launch of K5's expert-indexed GEMV over the N * k (token, expert)
    pairs; the pairs are device tensors built by elementwise ops, so the
    route reads nothing on the host and has no shape that depends on the
    data (the decode steps of `DecodeBlocks`, `BatchGenerator` and the
    speculative rounds are captured);
  * the prefill route (`grouped_route`): more tokens, eager.  The pairs are
    sorted by expert on the device, the per-expert counts fetched once per
    layer, then each expert with rows runs K5 on its rows (the GEMV at up
    to 8 rows, the GEMM above) and the outputs go back to their pairs.  An
    expert whose slice K5's 2-D rule refuses (at 4 bits a row of an odd
    number of groups, which the GEMM's group pairs cannot take: Qwen1.5-MoE's
    down projection, K = 1408, at g = 128) runs its rows through the
    expert-indexed entry instead.  Reached inside a capture, it raises.
- other stacks on CUDA (a group size K5 does not take, a per-channel
  stack): the masked scan, as the reference's route leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import linear
from .quant import (ChannelQuantizedTensor, QuantizedTensor,
                    channel_quantized_matmul, qmm_kernel_route,
                    quantized_matmul)

__all__ = ["topk_router", "switch_mlp", "group_expert_select", "switch_glu",
           "switch_glu_scan", "pairs_route",
           "grouped_route", "PREFILL_MIN_TOKENS", "stats"]

# tokens above which an eager call takes the prefill route
PREFILL_MIN_TOKENS = 64

# host-side tallies of the prefill route (it is never captured): its calls
# and the experts it ran, each one K5 call per projection
stats = {"grouped_calls": 0, "grouped_experts": 0}


def topk_router(x: torch.Tensor, gate_w, top_k: int,
                norm_topk_prob: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices [N, k] int64, weights [N, k] f32): softmax over the router's
    f32 logits, then the top k, renormalised.  Ties between the k-th and
    the (k+1)-th score may order differently from `jax.lax.top_k`."""
    logits = linear({"weight": gate_w}, x).float()
    probs = torch.softmax(logits, dim=-1)
    weights, indices = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return indices, weights


def group_expert_select(logits: torch.Tensor, bias: torch.Tensor, top_k: int,
                        n_group: int, topk_group: int,
                        routed_scaling_factor: float, norm_topk_prob: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3 "noaux_tc" routing: sigmoid scores plus the correction
    bias select the experts, the plain sigmoid scores weight them; only the
    topk_group groups (ranked by their top-2 score sum) stay eligible."""
    N, E = logits.shape
    scores = torch.sigmoid(logits.float())
    sel = scores + bias.float()[None]
    if n_group > 1:
        g = sel.reshape(N, n_group, E // n_group)
        group_scores = torch.topk(g, 2, dim=-1).values.sum(-1)
        keep_idx = torch.topk(group_scores, topk_group, dim=-1).indices
        keep = torch.zeros((N, n_group), dtype=torch.bool,
                           device=logits.device).scatter_(-1, keep_idx, True)
        sel = torch.where(keep[..., None], g, 0.0).reshape(N, E)
    indices = torch.topk(sel, top_k, dim=-1).indices
    weights = torch.gather(scores, -1, indices)
    if top_k > 1 and norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return indices, weights * routed_scaling_factor


def _expert(w, e: int):
    """Expert e of a stacked weight [E, out, in], as views."""
    if isinstance(w, (QuantizedTensor, ChannelQuantizedTensor)):
        return w.layer(e)
    return w[e]


def _expert_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.T for one expert's weight [out, in] (per-channel, group-affine
    or dense), in x's dtype."""
    if isinstance(w, ChannelQuantizedTensor):
        return channel_quantized_matmul(x, w)
    if isinstance(w, QuantizedTensor):
        return quantized_matmul(x, w, transpose=True)
    return torch.matmul(x, w.to(x.dtype).transpose(-1, -2))


def _scan(x, ins, out, indices, weights, hidden, biases):
    """The reference's masked scan over every expert: ins are the input
    projections (gate and up, or up), out the down projection, hidden maps
    their outputs to down's input; biases (one [E, width] per projection)
    or None.  On the CPU the experts that no token chose are skipped:
    their terms are zeros, so the sum is the same (in the same ascending
    order); on a device every expert runs, as finding them would read it."""
    dtype = x.dtype
    acc = None
    experts = range(out.shape[0])
    if x.device.type == "cpu":
        experts = sorted(set(indices.reshape(-1).tolist()))
    for e in experts:
        w_tok = ((indices == e).float() * weights.float()).sum(dim=-1)
        hs = [_expert_matmul(x, _expert(w, e)) for w in ins]
        if biases is not None:
            hs = [h + b[e].to(dtype) for h, b in zip(hs, biases)]
        y = _expert_matmul(hidden(*hs), _expert(out, e))
        if biases is not None:
            y = y + biases[-1][e].to(dtype)
        term = w_tok[:, None].to(dtype) * y
        acc = term if acc is None else acc + term
    return acc


def _combine(y: torch.Tensor, weights: torch.Tensor, dtype) -> torch.Tensor:
    """A token's k expert outputs y [N, k, D] times its routing weights,
    added in f32 and rounded once to dtype."""
    return (y.float() * weights.float()[..., None]).sum(dim=1).to(dtype)


def _rows_matmul(x: torch.Tensor, w, e: int) -> torch.Tensor:
    """x @ expert e of the stack w, for the prefill route: the expert's
    slice through `_expert_matmul`, unless it is an mlx slice that K5's
    2-D rule refuses; then K5's expert-indexed entry with every row on
    expert e (the route is taken only for stacks that entry takes)."""
    we = _expert(w, e)
    if isinstance(we, QuantizedTensor) and not qmm_kernel_route(we):
        from ..ops.qmatmul import quantized_matmul_experts

        experts = torch.full((x.shape[0],), e, dtype=torch.int32,
                             device=x.device)
        return quantized_matmul_experts(x.contiguous(), w, experts)
    return _expert_matmul(x, we)


def _pairs_matmul(x: torch.Tensor, w, experts: torch.Tensor, rows):
    """[P, out]: row p is x[rows[p]] (x row p where rows is None) times
    expert experts[p] of the stack w: K5's expert-indexed entry for an mlx
    stack, a gathered batched product for a dense one."""
    if isinstance(w, QuantizedTensor):
        from ..ops.qmatmul import quantized_matmul_experts

        return quantized_matmul_experts(x, w, experts, rows)
    xr = x if rows is None else x[rows.long()]
    return torch.bmm(w[experts.long()].to(x.dtype),
                     xr.unsqueeze(-1)).squeeze(-1)


def pairs_route(x, ins, out, indices, weights, hidden, biases=None):
    """The decode route: each projection is one call over the N * k (token,
    expert) pairs (pair p is token p // k and expert indices.flat[p]); no
    host read, no shape that depends on the data."""
    N, k = indices.shape
    P = N * k
    experts = indices.reshape(-1).to(torch.int32)
    rows = torch.div(torch.arange(P, device=x.device), k,
                     rounding_mode="floor").to(torch.int32)
    hs = [_pairs_matmul(x, w, experts, rows) for w in ins]
    if biases is not None:
        hs = [h + b[experts.long()].to(x.dtype) for h, b in zip(hs, biases)]
    y = _pairs_matmul(hidden(*hs), out, experts, None)
    if biases is not None:
        y = y + biases[-1][experts.long()].to(x.dtype)
    return _combine(y.reshape(N, k, -1), weights, x.dtype)


def grouped_route(x, ins, out, indices, weights, hidden, biases=None):
    """The prefill route: pairs sorted by expert on the device, one host
    fetch of the per-expert counts, then each expert with rows runs its
    projections on its rows (K5's GEMV up to 8 rows, its GEMM above, for an
    mlx stack); the outputs return to their pairs.  Raises inside a CUDA
    graph capture, where the fetch cannot run."""
    if _capturing(x):
        raise RuntimeError("the grouped expert route reads the per-expert "
                           "counts on the host and cannot be captured")
    N, k = indices.shape
    E = out.shape[0]
    flat = indices.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).index_add_(
        0, flat, torch.ones_like(flat)).tolist()  # the one host fetch
    xs = x[torch.div(order, k, rounding_mode="floor")]  # pair rows, sorted
    ys = None
    start = 0
    for e, c in enumerate(counts):
        if c == 0:
            continue
        xe = xs[start:start + c]
        hs = [_rows_matmul(xe, w, e) for w in ins]
        if biases is not None:
            hs = [h + b[e].to(x.dtype) for h, b in zip(hs, biases)]
        ye = _rows_matmul(hidden(*hs), out, e)
        if biases is not None:
            ye = ye + biases[-1][e].to(x.dtype)
        if ys is None:
            ys = x.new_empty((N * k, ye.shape[-1]))
        ys[start:start + c] = ye
        start += c
        stats["grouped_experts"] += 1
    stats["grouped_calls"] += 1
    y = torch.empty_like(ys).index_copy_(0, order, ys)
    return _combine(y.reshape(N, k, -1), weights, x.dtype)


def _capturing(x: torch.Tensor) -> bool:
    """Whether x's stream is being captured into a CUDA graph."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def _takes_pairs(w) -> bool:
    """Whether the card's routes take a stacked expert weight: an mlx stack
    that K5's expert-indexed entry takes, or a dense tensor."""
    from ..ops.qmatmul import experts_kernel_route

    return isinstance(w, torch.Tensor) or experts_kernel_route(w)


def _route(x, ins, out, indices, weights, hidden, biases):
    if x.device.type == "cuda" and all(map(_takes_pairs, (*ins, out))):
        if x.shape[0] <= PREFILL_MIN_TOKENS or _capturing(x):
            return pairs_route(x, ins, out, indices, weights, hidden, biases)
        return grouped_route(x, ins, out, indices, weights, hidden, biases)
    return _scan(x, ins, out, indices, weights, hidden, biases)


def _silu_glu(g, u):
    return F.silu(g) * u


def _relu2(v):
    return torch.square(F.relu(v))


def switch_glu(x: torch.Tensor, gate_proj, up_proj, down_proj,
               indices: torch.Tensor, weights: torch.Tensor, act2=None,
               biases=None) -> torch.Tensor:
    """Top-k expert SwiGLU over x [N, D]: stacked gate / up [E, I, D] and
    down [E, D, I] (dense or quantized), indices and weights [N, k];
    act2(gate, up) defaults to silu(gate) * up; biases (bg [E, I], bu [E,
    I], bd [E, D]) or None.  Routes as the module docstring says."""
    return _route(x, (gate_proj, up_proj), down_proj, indices, weights,
                  act2 or _silu_glu, biases)


def switch_glu_scan(x, gate_proj, up_proj, down_proj, indices, weights,
                    act2=None, biases=None) -> torch.Tensor:
    """`switch_glu` by the reference's masked scan, on any device."""
    return _scan(x, (gate_proj, up_proj), down_proj, indices, weights,
                 act2 or _silu_glu, biases)


def switch_mlp(x: torch.Tensor, up_proj, down_proj, indices: torch.Tensor,
               weights: torch.Tensor, act=None,
               biases: Optional[tuple] = None) -> torch.Tensor:
    """Top-k expert 2-layer MLP (no gate branch): up [E, I, D], down
    [E, D_out, I]; act defaults to relu(v) ** 2; biases (bu [E, I], bd [E,
    D_out]) or None.  Routes as `switch_glu`."""
    return _route(x, (up_proj,), down_proj, indices, weights, act or _relu2,
                  biases)
