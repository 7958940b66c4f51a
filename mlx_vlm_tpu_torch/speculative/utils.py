"""Speculative decoding with a draft model: draft k tokens, verify them in
one target forward.

Port of mlx_vlm_tpu/speculative/utils.py (load_drafter :142,
validate_drafter_compatibility :154, rejection_walk :164,
SpeculativeEngine :203, SpecStats :313, speculative_generate_step :323)
for the vanilla drafter (an independent smaller language model that
shares the target's tokenizer), and `eagle3_generate_step` (:38) for the
target-coupled EAGLE-3 and MTP drafters (speculative/drafters/), which
need the target's `forward_captured` (the llama decoder's; DFlash and
DDTree are in dflash.py and ddtree.py).

A round is the reference's two programs on device tensors: k drafter
steps (`SpeculativeEngine.draft`, each through the drafter's `step_logits`:
one K3 launch when its fused route is on, else its per-linear layer
stack; then `make_batched_sampler`), then one target forward over
[prev, d1..dk] at M-RoPE positions cursor + rope delta + arange(k + 1),
`batched_filtered_probs` of both models, the rejection walk and the
target's rewind to cursor + n_acc + 1 (`SpeculativeEngine.verify`).  The
caches' cursors are int32 device tensors, so rewinding is an in-place
write and nothing in a round reads the host.

The reference's host branch after a full accept (one `sync` forward that
writes d_k's K/V into the drafter, :440-452) is made unconditional here:
every round ends with that drafter forward at the drafter's cursor
(start + k), then rewinds the drafter to start + n_acc + 1.  After a
partial accept the write lands past the cursor, where the mask hides it
and the next round overwrites it before any query can see it; after a
full accept the cursor keeps it.  So a round never branches on the host,
at the cost of one drafter step a round, and the tokens and `SpecStats`
are the reference's.

On the card the first round runs eagerly and the second is captured once
per request as a CUDA graph (ops/_cuda.py `Graph`), which every later
round replays under sync debug mode "error", with one host fetch of the
round's tokens and accept count (`CapturedRounds`).  A capture that fails
raises; nothing falls back to eager rounds.  On the CPU every round runs
eagerly, with the same state and the same one fetch.

The walk accepts draft i only where u_i * p_draft(d_i) < p_target(d_i);
the reference's `<=` (:180) also accepts a draft whose target probability
is 0 when u_i == 0.0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Generator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.sampling import batched_filtered_probs, make_batched_sampler
from ..generate.ar import CACHE_BUCKET, _NoSync, _pad_axis, make_cache
from ..generate.common import bidirectional_prefix, round_up

__all__ = ["SpecStats", "SpeculativeEngine", "load_drafter",
           "rejection_walk", "run_speculative_rounds",
           "speculative_generate_step", "validate_drafter_compatibility",
           "walk_noise", "eagle3_generate_step", "Eagle3Rounds",
           "greedy_walk"]

# The last request's rounds (its `SpeculativeRounds`: the caches, the
# captured round and `stats`), held until the next request starts
last_rounds = None


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    def add(self, k: int, n_acc: int) -> None:
        self.rounds += 1
        self.drafted += k
        self.accepted += n_acc


def load_drafter(path_or_repo: str, dtype=torch.bfloat16,
                 kind: str = "vanilla", device="cuda"):
    """Load a vanilla draft model (reference :142) with the port's loader,
    onto the card unless `device` says otherwise.  A target-coupled kind
    raises ValueError: it loads against its target through
    `speculative.drafters.load_drafter` (the reference ignores `kind`
    here and loads any directory as a plain model)."""
    if kind != "vanilla":
        raise ValueError(
            f"{kind} drafters load against their target: use "
            f"speculative.drafters.load_drafter(path, target_model)")
    from ..utils.loader import load_model

    return load_model(path_or_repo, dtype=dtype, device=device)


def validate_drafter_compatibility(model, drafter) -> None:
    """Vocab-size check (reference drafters/__init__.py:37); and a model
    whose decoder has a bidirectional prefix (PaliGemma's) is refused: a
    verify of k + 1 rows would take the prefix's mask, no causal order
    among the drafts, where the reference's verify does so and returns
    other tokens than greedy decoding (ROADMAP, known faults in the
    reference)."""
    for m in (model, drafter):
        if bidirectional_prefix(m):
            raise ValueError(
                f"{m.config.model_type}: speculative decoding verifies "
                f"several rows at once, which its bidirectional prefix "
                f"would let see each other")
    tv = model.config_dict.get("vocab_size") or model.config_dict.get(
        "text_config", {}).get("vocab_size")
    dv = drafter.config_dict.get("vocab_size")
    if tv and dv and tv != dv:
        raise ValueError(f"drafter vocab {dv} != target vocab {tv}")


def walk_noise(B: int, k: int, V: int, gen: torch.Generator,
               device) -> tuple:
    """The walk's random draws from `gen`: uniforms u [B, k] in [0, 1) and
    Gumbel noise [B, V] for the residual draw (-log E, E ~ Exp(1) clamped
    away from 0)."""
    u = torch.rand((B, k), generator=gen, device=device)
    e = torch.empty((B, V), device=device).exponential_(1, generator=gen)
    return u, -torch.log(e.clamp_min(torch.finfo(torch.float32).tiny))


def rejection_walk(pt: torch.Tensor, pd: torch.Tensor,
                   draft_toks: torch.Tensor, u: torch.Tensor,
                   gumbel: torch.Tensor) -> tuple:
    """Speculative rejection-sampling walk (reference utils.py:164-200).

    pt [B, k+1, V]: filtered target probs at each draft position (+1
    bonus); pd [B, k, V]: filtered draft probs; draft_toks [B, k] drawn
    from pd; u [B, k] uniforms and gumbel [B, V] noise from the caller
    (`walk_noise`).  Draft i is accepted while u_i * pd(d_i) < pt(d_i); the
    first rejected position draws from the residual max(pt - pd, 0) as
    argmax(log(residual + 1e-30) + gumbel), the reference's categorical; a
    full accept draws the bonus from pt.  Returns (out [B, k+1], n_acc
    [B]): out[:, :n_acc + 1] are committed."""
    B, k = draft_toks.shape
    V = pt.shape[-1]
    sel = draft_toks[..., None]
    dsel = pd.gather(2, sel)[..., 0]
    tsel = pt[:, :k].gather(2, sel)[..., 0]
    accept = u * dsel.clamp_min(1e-20) < tsel
    n_acc = accept.long().cumprod(dim=1).sum(dim=1)  # first rejection
    at = n_acc[:, None, None].expand(B, 1, V)
    pt_n = pt.gather(1, at)[:, 0]
    pd_n = F.pad(pd, (0, 0, 0, 1)).gather(1, at)[:, 0]
    residual = (pt_n - pd_n).clamp_min(0.0)
    corr = torch.argmax(torch.log(residual + 1e-30) + gumbel, dim=-1)
    idx = torch.arange(k + 1, device=pt.device)[None, :]
    out = torch.where(idx < n_acc[:, None], F.pad(draft_toks, (0, 1)),
                      torch.zeros_like(idx))
    out = torch.where(idx == n_acc[:, None], corr[:, None], out)
    return out, n_acc


def sampling_params(B: int, device, temperature: float = 0.0,
                    top_p: float = 0.0, min_p: float = 0.0,
                    top_k: int = -1) -> dict:
    """make_batched_sampler's per-row parameters: [B] tensors on `device`."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"temp": torch.full((B,), temperature, **f32),
            "top_p": torch.full((B,), top_p, **f32),
            "min_p": torch.full((B,), min_p, **f32),
            "top_k": torch.full((B,), top_k, dtype=torch.int64,
                                device=device)}


def _rows_positions(start: torch.Tensor, B: int, n: int) -> torch.Tensor:
    """Position ids [3, B, n]: start + arange(n) on every M-RoPE stream,
    from a 0-dim or [B] start on the device."""
    ar = torch.arange(n, device=start.device)
    return (start.long().expand(B)[:, None] + ar)[None].expand(3, B, n)


class SpeculativeEngine:
    """The draft / sync / verify programs of a (target, drafter) pair
    (reference :203-310), as functions of device tensors that write the
    caches in place.  Rows at temperature 0 reduce exactly to greedy
    token matching: `batched_filtered_probs` gives them one-hot argmax
    distributions."""

    def __init__(self, model, drafter, num_draft: int = 4):
        self.model, self.drafter, self.k = model, drafter, num_draft
        self.lm = model.language_model
        self.lp = model.params["language_model"]
        self.dlm = drafter.language_model
        self.dlp = drafter.params["language_model"]
        self.sampler = make_batched_sampler()

    def drafter_logits(self, d_cache, tok: torch.Tensor) -> torch.Tensor:
        """One drafter step through its `step_logits`, writing `tok`'s [B]
        K/V at the drafter's cursor (which advances by one) -> f32 logits
        [B, V].  At B = 1 on a plain KVCache with the drafter's fused route
        on, that is one K3 launch with the head inside (the reference's
        `lm(...)` at :236 and its `sync` at :263); otherwise (the batch's
        per-row cache) the per-linear path."""
        emb = self.dlm.embed(self.dlp, tok[:, None])
        return self.dlm.step_logits(
            self.dlp, emb, d_cache,
            _rows_positions(d_cache.offset, tok.shape[0], 1))[:, 0].float()

    def draft(self, d_cache, tok: torch.Tensor, sp: dict,
              gen: torch.Generator) -> tuple:
        """k drafter steps from `tok` [B]: (draft tokens [B, k], their
        logits [B, k, V]); the drafter's cursor advances by k."""
        toks, logits = [], []
        for _ in range(self.k):
            lg = self.drafter_logits(d_cache, tok)
            tok = self.sampler(lg, sp, gen)
            toks.append(tok)
            logits.append(lg)
        return torch.stack(toks, dim=1), torch.stack(logits, dim=1)

    def verify(self, cache, prev_tok: torch.Tensor, draft_toks: torch.Tensor,
               d_logits: torch.Tensor, deltas: torch.Tensor, sp: dict,
               gen: torch.Generator) -> tuple:
        """One target forward over [prev, d1..dk] at positions cursor +
        rope delta + arange(k + 1), the walk, and the target's cursor
        rewound from cursor + k + 1 to cursor + max(n_acc) + 1.  Returns
        (out [B, k+1], n_acc [B])."""
        B, k = draft_toks.shape
        seq = torch.cat([prev_tok[:, None], draft_toks], dim=1)
        pos = _rows_positions(cache.offset.long() + deltas, B, k + 1)
        hidden = self.lm(self.lp, self.lm.embed(self.lp, seq), cache, pos)
        logits = self.lm.logits(self.lp, hidden).float()
        pt = batched_filtered_probs(logits, sp)
        pd = batched_filtered_probs(d_logits, sp)
        u, g = walk_noise(B, k, pt.shape[-1], gen, pt.device)
        out, n_acc = rejection_walk(pt, pd, draft_toks, u, g)
        cache.offset.add_((n_acc.max() - k).to(torch.int32))
        return out, n_acc


class CapturedRounds:
    """A round's dispatch: `round()` (a subclass's) computes on the
    state tensors and writes its results into `result`, a float64 device
    tensor; `run()` puts one round on the device and returns `result` on
    the host, in one fetch.  On a CUDA device the first round runs
    eagerly on a side stream (making every lazy piece of device state:
    rope tables, the kernels' ticket words) and is waited for, the next
    is captured there once (`ops/_cuda.Graph`, with the generator's state
    registered) and every later round replays it under sync debug mode
    "error".  `stats`: the first round's and the capture's host seconds,
    captures, rounds, replays, fetches and `round_s` (host seconds of the
    rounds, dispatch to fetched)."""

    def __init__(self, device, gen: torch.Generator, result_shape: tuple):
        self.dev, self.gen = device, gen
        self.use_graph = device.type == "cuda"
        self.graph = None
        self.result = torch.zeros(result_shape, dtype=torch.float64,
                                  device=device)
        self.host = torch.empty(result_shape, dtype=torch.float64,
                                pin_memory=self.use_graph)
        self.event = torch.cuda.Event() if self.use_graph else None
        self.stats = dict(first_s=0.0, capture_s=0.0, captures=0, rounds=0,
                          replays=0, fetches=0, round_s=0.0)

    def round(self) -> None:
        raise NotImplementedError

    def _capture(self) -> None:
        from ..ops._cuda import Graph

        tic = time.perf_counter()
        main = torch.cuda.current_stream(self.dev)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.round()
        side.synchronize()
        toc = time.perf_counter()
        self.graph = Graph()
        self.graph.capture(self.round, side, generators=(self.gen,))
        main.wait_stream(side)
        self.stats["first_s"] = toc - tic
        self.stats["capture_s"] = time.perf_counter() - toc
        self.stats["captures"] += 1

    def run(self) -> np.ndarray:
        tic = time.perf_counter()
        if self.use_graph and self.graph is None:
            self._capture()
        else:
            with _NoSync(self.dev):
                if self.use_graph:
                    self.graph.replay()
                    self.stats["replays"] += 1
                else:
                    self.round()
        with _NoSync(self.dev):
            self.host.copy_(self.result, non_blocking=True)
            if self.event is not None:
                self.event.record()
        if self.event is not None:
            self.event.synchronize()
        self.stats["rounds"] += 1
        self.stats["fetches"] += 1
        self.stats["round_s"] += time.perf_counter() - tic
        return self.host.numpy().copy()


class SpeculativeRounds(CapturedRounds):
    """The single-stream round (reference :424-457) on device state: the
    last committed token `tok` [1], both caches with their 0-dim cursors,
    the rope delta [1], the sampling parameters and the generator.
    `result` [1, k + 2]: the round's k + 1 tokens, then its accept
    count."""

    def __init__(self, engine: SpeculativeEngine, cache, d_cache,
                 deltas: torch.Tensor, sp: dict, gen: torch.Generator):
        super().__init__(deltas.device, gen, (1, engine.k + 2))
        self.engine, self.cache, self.d_cache = engine, cache, d_cache
        self.deltas, self.sp = deltas, sp
        self.tok = torch.zeros((1,), dtype=torch.int64, device=self.dev)
        self.d_start = torch.zeros((), dtype=torch.int32, device=self.dev)

    def round(self) -> None:
        e, k = self.engine, self.engine.k
        self.d_start.copy_(self.d_cache.offset)
        d_toks, d_logits = e.draft(self.d_cache, self.tok, self.sp, self.gen)
        out, n_acc = e.verify(self.cache, self.tok, d_toks, d_logits,
                              self.deltas, self.sp, self.gen)
        # the sync: d_k's K/V at start + k (kept only by a full accept; its
        # logits unused), then the drafter's cursor at start + n_acc + 1
        e.drafter_logits(self.d_cache, out[:, k - 1])
        self.d_cache.offset.copy_(self.d_start + n_acc.max().to(torch.int32)
                                  + 1)
        self.tok.copy_(out.gather(1, n_acc[:, None])[:, 0])
        self.result.copy_(torch.cat([out, n_acc[:, None]], dim=1))


def run_speculative_rounds(*args, **kwargs):
    """Alias for the generator API (reference utils.py:33)."""
    return speculative_generate_step(*args, **kwargs)


def speculative_generate_step(
    inputs_embeds: torch.Tensor,  # [1, S, D] (target embeddings)
    model,
    drafter,
    input_ids: Optional[np.ndarray] = None,  # [1, S] for the drafter prefill
    *,
    position_ids: Optional[np.ndarray] = None,  # [3, 1, S]
    rope_deltas: Optional[np.ndarray] = None,  # [1, 1]
    max_tokens: int = 256,
    num_draft: int = 4,
    prefill_step_size: int = 512,
    stats: Optional[SpecStats] = None,
    temperature: float = 0.0,
    top_p: float = 0.0,
    min_p: float = 0.0,
    top_k: int = -1,
    seed: Optional[int] = None,
) -> Generator[Tuple[np.ndarray, np.ndarray], None, None]:
    """Speculative decoding, B = 1 (reference :323-457): yields (token [1],
    zeros [1]) numpy pairs, as the reference does.

    Distribution-preserving at any temperature through the rejection walk;
    at temperature 0 it is greedy matching, so the tokens are the target's
    plain greedy decode.  Both caches are bf16 `KVCache`s of
    round_up(S + max_tokens + k + 2, 256) rows.  The target prefills the
    prompt's embeddings in chunks; the drafter prefills the prompt's ids
    at the target's position ids (the reference's :372-397).  Raises
    before any work for a drafter of another vocabulary, on another
    device, or without `input_ids`.  The request's `SpeculativeRounds`
    stays in `last_rounds` until the next request; its `stats` also count
    the prefill chunks (each model's)."""
    B, S, _ = inputs_embeds.shape
    if B != 1:
        raise ValueError("the speculative path is single-stream")
    if input_ids is None:
        raise ValueError("speculative decoding needs input_ids for the "
                         "drafter")
    validate_drafter_compatibility(model, drafter)
    dev = inputs_embeds.device
    if torch.device(drafter.device or "cpu") != torch.device(
            model.device or "cpu"):
        raise ValueError(f"drafter on {drafter.device}, target on "
                         f"{model.device}")
    global last_rounds
    last_rounds = None
    k = num_draft
    stats = stats if stats is not None else SpecStats()
    engine = SpeculativeEngine(model, drafter, num_draft)
    if position_ids is None:
        position_ids = np.broadcast_to(np.arange(S, dtype=np.int64),
                                       (3, B, S))
    if rope_deltas is None:
        rope_deltas = np.zeros((B, 1), np.int64)
    deltas = torch.from_numpy(
        np.asarray(rope_deltas, np.int64).reshape(-1)[:B].copy()).to(dev)

    capacity = round_up(S + max_tokens + k + 2, CACHE_BUCKET)
    cache = make_cache(model, B, capacity, inputs_embeds.dtype, device=dev)
    d_cache = make_cache(drafter, B, capacity, inputs_embeds.dtype,
                         device=dev)
    # chunks of one length for both models; halved until the padded
    # prompt fits the caches, since an index write past them is refused
    step = min(prefill_step_size, round_up(S, CACHE_BUCKET))
    S_pad = round_up(S, step)
    while S_pad > capacity and step > 64:
        step = max(64, step // 2)
        S_pad = round_up(S, step)
    if S_pad > capacity:
        raise ValueError(f"kv capacity {capacity} too small for the padded "
                         f"prompt {S_pad}")
    pos_pad = _pad_axis(np.asarray(position_ids, np.int64), 2, S_pad)
    embeds = F.pad(inputs_embeds, (0, 0, 0, S_pad - S))
    ids = torch.from_numpy(np.asarray(input_ids, np.int64)).to(dev)
    d_embeds = F.pad(engine.dlm.embed(engine.dlp, ids), (0, 0, 0, S_pad - S))
    logits = None
    for c0 in range(0, S_pad, step):
        pchunk = torch.from_numpy(
            np.ascontiguousarray(pos_pad[:, :, c0:c0 + step])).to(dev)
        hidden = engine.lm(engine.lp, embeds[:, c0:c0 + step], cache, pchunk)
        if c0 <= S - 1 < c0 + step:
            h_last = hidden[:, S - 1 - c0:S - c0]
            logits = engine.lm.logits(engine.lp, h_last)[:, 0].float()
        engine.dlm(engine.dlp, d_embeds[:, c0:c0 + step], d_cache, pchunk)
    # the padding wrote rows past S; they stay masked once the cursors are S
    cache.offset.fill_(S)
    d_cache.offset.fill_(S)
    if max_tokens <= 0:
        return

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed if seed is not None else time.time_ns() % 2**31)
    sp = sampling_params(B, dev, temperature, top_p, min_p, top_k)
    rounds = last_rounds = SpeculativeRounds(engine, cache, d_cache, deltas,
                                             sp, gen)
    rounds.stats["prefill_chunks"] = S_pad // step
    rounds.tok.copy_(engine.sampler(logits, sp, gen))  # the first token
    first = rounds.tok.cpu().numpy()
    rounds.stats["fetches"] += 1
    yield first, np.zeros((B,), np.float32)
    n = 1
    while n < max_tokens:
        res = rounds.run()[0]
        n_acc = int(res[k + 1])
        stats.add(k, n_acc)
        for t in res[:n_acc + 1].astype(np.int64):
            if n >= max_tokens:
                break
            yield np.asarray([t]), np.zeros((B,), np.float32)
            n += 1


def greedy_walk(greedy: torch.Tensor, draft_toks: torch.Tensor,
                cap: Optional[int] = None) -> tuple:
    """The target-coupled kinds' greedy walk (reference :85-97,
    dflash.py:96-106): n_acc [B] = the drafts that equal the target's
    greedy tokens before the first that does not (at most `cap`); out
    [B, k + 1] = the accepted drafts, then the target's greedy token at
    n_acc (the bonus), then zeros."""
    k = draft_toks.shape[1]
    n_acc = (greedy[:, :k] == draft_toks).long().cumprod(dim=1).sum(dim=1)
    if cap is not None:
        n_acc = n_acc.clamp(max=cap)
    idx = torch.arange(k + 1, device=greedy.device)[None, :]
    out = torch.where(idx < n_acc[:, None], F.pad(draft_toks, (0, 1)),
                      torch.zeros_like(idx))
    bonus = greedy.gather(1, n_acc[:, None])
    out = torch.where(idx == n_acc[:, None], bonus, out)
    return out, n_acc


def text_positions(start: torch.Tensor, n: int) -> torch.Tensor:
    """The llama decoder's own positions [1, n]: start + arange(n), from a
    0-dim device cursor (the reference builds M-RoPE [3, B, n] ids)."""
    return (start.long() + torch.arange(n, device=start.device))[None]


def captured_prefill(lm, lp: dict, embeds: torch.Tensor, cache) -> tuple:
    """The target's prompt through `forward_captured` in one chunk at
    positions 0..S-1: (f32 logits [1, V] of the last row, the captured
    stack [L, 1, S, D]); the cache holds the prompt after it."""
    S = embeds.shape[1]
    hidden, hiddens = lm.forward_captured(lp, embeds, cache,
                                          text_positions(cache.offset, S))
    return lm.logits(lp, hidden[:, -1:])[:, 0].float(), hiddens


class Eagle3Rounds(CapturedRounds):
    """The EAGLE-3 / MTP round (reference :116-139) on device state: the
    last committed token `tok` [1], the fused feature `feat` [1, D] at the
    position before it, the target's cache and the drafter's one-layer
    cache with their 0-dim cursors.  k draft steps from the drafter's
    cursor, the target's `forward_captured` over [tok, d1..dk] at text
    positions, the greedy walk (n_acc at most k - 1, as the reference
    caps it: the drafter never wrote d_k), the target's cursor rewound by
    offset - (k + 1) + n_acc + 1, the drafter's set to its round start +
    n_acc + 1 (the reference's host mirror `d_off`, here on the device),
    and the feature at the last accepted position.  `result` [1, k + 2]:
    the round's k + 1 tokens, then n_acc."""

    def __init__(self, model, drafter, params: dict, cache, d_cache, k: int,
                 gen: torch.Generator):
        dev = cache.offset.device
        super().__init__(dev, gen, (1, k + 2))
        self.lm, self.lp = model.language_model, model.params["language_model"]
        self.drafter, self.params, self.k = drafter, params, k
        self.cache, self.d_cache = cache, d_cache
        self.draft = drafter.draft_fn(k)
        self.tok = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.feat = None  # [1, D], set from the prefill
        self.d_start = torch.zeros((), dtype=torch.int32, device=dev)

    def round(self) -> None:
        k, lm, lp = self.k, self.lm, self.lp
        self.d_start.copy_(self.d_cache.offset)
        d_toks = self.draft(self.params, self.d_cache, self.tok, self.feat,
                            self.d_start)
        seq = torch.cat([self.tok[:, None], d_toks], dim=1)
        hidden, hiddens = lm.forward_captured(
            lp, lm.embed(lp, seq), self.cache,
            text_positions(self.cache.offset, k + 1))
        greedy = torch.argmax(lm.logits(lp, hidden).float(), dim=-1)
        out, n_acc = greedy_walk(greedy, d_toks, cap=k - 1)
        feats = self.drafter.fuse_features(self.params, hiddens)
        at = n_acc[:, None, None].expand(1, 1, feats.shape[-1])
        self.feat.copy_(feats.gather(1, at)[:, 0])
        acc = n_acc.max().to(torch.int32)
        self.cache.offset.add_(acc - k)
        self.d_cache.offset.copy_(self.d_start + acc + 1)
        self.tok.copy_(out.gather(1, n_acc[:, None])[:, 0])
        self.result.copy_(torch.cat([out, n_acc[:, None]], dim=1))


def eagle3_generate_step(
    inputs_embeds: torch.Tensor,  # [1, S, D]
    model,
    drafter,  # drafters.eagle3.Eagle3Drafter or drafters.mtp.MTPDrafter
    drafter_params: dict,
    *,
    max_tokens: int = 256,
    num_draft: int = 4,
    stats: Optional[SpecStats] = None,
) -> Generator[Tuple[np.ndarray, np.ndarray], None, None]:
    """EAGLE-3 style speculative decoding, B = 1 (reference :38): yields
    (token [1], zeros [1]) numpy pairs.

    The target runs `forward_captured`, so every verify also yields the
    layer stack; the drafter takes the fused capture at the last committed
    position and autoregresses its own single layer.  Greedy and lossless
    (the walk commits only the target's greedy tokens).  The drafter's
    cache starts cold at the prompt (no drafter prefill), as in the
    reference.  Both caches are `KVCache`s of round_up(S + max_tokens +
    k + 2, 256) rows in the embeddings' dtype.  A round is `Eagle3Rounds`:
    on the card the first runs eagerly, the second is captured and every
    later one replays it, with one host fetch a round (n_acc and the
    tokens); `last_rounds` holds it until the next request."""
    B, S, _ = inputs_embeds.shape
    if B != 1:
        raise ValueError("the EAGLE-3 path is single-stream")
    global last_rounds
    last_rounds = None
    stats = stats if stats is not None else SpecStats()
    dev, dt = inputs_embeds.device, inputs_embeds.dtype
    lm, lp = model.language_model, model.params["language_model"]
    k = num_draft
    capacity = round_up(S + max_tokens + k + 2, CACHE_BUCKET)
    cache = make_cache(model, B, capacity, dt, device=dev)
    d_cache = drafter.init_cache(B, capacity, dt, device=dev)
    logits, hiddens = captured_prefill(lm, lp, inputs_embeds, cache)
    rounds = last_rounds = Eagle3Rounds(model, drafter, drafter_params,
                                        cache, d_cache, k,
                                        torch.Generator(device=dev))
    rounds.feat = drafter.fuse_features(drafter_params,
                                        hiddens[:, :, -1:])[:, 0].clone()
    rounds.tok.copy_(torch.argmax(logits, dim=-1))
    first = rounds.tok.cpu().numpy()
    rounds.stats["fetches"] += 1
    yield first, np.zeros((B,), np.float32)
    n = 1
    while n < max_tokens:
        res = rounds.run()[0]
        n_acc = int(res[k + 1])
        stats.add(k, n_acc)
        for t in res[:n_acc + 1].astype(np.int64):
            if n >= max_tokens:
                break
            yield np.asarray([t]), np.zeros((B,), np.float32)
            n += 1
