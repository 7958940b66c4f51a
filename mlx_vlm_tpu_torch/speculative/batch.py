"""Batched speculative decoding for serving.

Port of mlx_vlm_tpu/speculative/batch.py (SpeculativeBatchGenerator :51,
_drafter_admit :90, remove :119, pop_stats :128, the round :144-247,
next :250): draft / verify rounds over the whole continuous-batching slot
set, the rejection walk for rows at temperature > 0.

- The drafter holds its own `BatchKVCache` over the same slots.  Each
  round begins with a catch-up forward: the tokens committed by the
  previous round (1..k+1 of them, right-padded to k+1) run through the
  drafter at per-row positions, rewriting exactly the committed tokens'
  K/V; rows that accepted fewer leave stale K/V past their cursor, masked
  and overwritten later.  The catch-up's logits at each row's last valid
  token give draft token 1; k-1 single-token drafter steps give the rest.
- The verify is one target forward over [B, k+1] tokens at per-row
  cursors plus rope deltas, then the walk (speculative/utils.py
  `rejection_walk`) under each row's own sampling parameters: rows at
  temperature 0 reduce exactly to greedy matching.
- Rollback is a per-row cursor rewind (cursor + n_acc + 1; idle rows do
  not move).  The committed tokens become the next round's pending
  tokens on the device.

Every piece of round state is a device tensor that admission rewrites in
place: the pending tokens and their counts, the active mask, the rope
deltas and the sampling parameters.  So on the card the round's first run
is eager and the next is captured once per generator as a CUDA graph,
which every later round of every request replays, across admissions and
removals (speculative/utils.py `CapturedRounds`), with one host fetch a
round.  On the CPU every round runs eagerly.  `block_size` is at least
k + 1, so that BatchGenerator's cap on a row's max_tokens keeps a verify's
k + 1 writes inside the capacity.  A freed slot's cursors, the drafter's
too, are parked at 0.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import cache as cache_lib
from ..core.sampling import batched_filtered_probs
from ..generate.ar import make_cache
from ..generate.batch import BatchGenerator, BatchRequest
from ..generate.common import round_up
from .utils import (CapturedRounds, SpecStats, SpeculativeEngine,
                    _rows_positions, rejection_walk,
                    validate_drafter_compatibility, walk_noise)


class _BatchRounds(CapturedRounds):
    """The batched round (reference :144-247) on the generator's device
    state: `pending` [B, k+1] (the tokens committed last round, zero
    padded), `pend_len` [B], `active` [B] bool, `deltas` [B], the
    sampling parameters and the generator.  `result` [B, 2k+3]: each row's
    k + 1 tokens, their logprobs under the target's filtered distribution,
    and its accept count.  `stats` also counts BatchGenerator's admissions,
    prefill chunks and heads, the drafter's prefill chunks and `decode_s`,
    the host seconds of the rounds."""

    def __init__(self, engine: SpeculativeEngine, cache, d_cache,
                 params: dict, gen: torch.Generator, B: int):
        dev = cache.offset.device
        k = engine.k
        super().__init__(dev, gen, (B, 2 * k + 3))
        self.engine, self.cache, self.d_cache = engine, cache, d_cache
        self.params = params
        self.pending = torch.zeros((B, k + 1), dtype=torch.int64, device=dev)
        self.pend_len = torch.ones((B,), dtype=torch.int64, device=dev)
        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.deltas = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.stats.update(admissions=0, prefill_chunks=0, prefill_heads=0,
                          drafter_chunks=0, decode_s=0.0)

    def admit(self, slot: int, first_tok: int) -> None:
        """A newly admitted row's pending token, written in place."""
        self.pending[slot] = 0
        self.pending[slot, 0] = first_tok
        self.pend_len[slot] = 1

    def round(self) -> None:
        e, k = self.engine, self.engine.k
        sp, gen, d_cache, cache = self.params, self.gen, self.d_cache, \
            self.cache
        B = self.pending.shape[0]
        act = self.active.to(torch.int32)
        # 1. the drafter catches up on the tokens committed last round
        d_off0 = d_cache.offset.clone()
        emb = e.dlm.embed(e.dlp, self.pending)
        hid = e.dlm(e.dlp, emb, d_cache, _rows_positions(d_off0, B, k + 1))
        idx = (self.pend_len - 1).clamp_min(0)
        h1 = hid.gather(1, idx[:, None, None].expand(B, 1, hid.shape[2]))
        d_next = d_off0 + self.pend_len.to(torch.int32) * act
        d_cache.offset.copy_(d_next)
        logits = [e.dlm.logits(e.dlp, h1)[:, 0].float()]
        toks = [e.sampler(logits[0], sp, gen)]
        # 2. k - 1 single-token drafter steps; idle rows do not move
        for _ in range(k - 1):
            before = d_cache.offset.clone()
            logits.append(e.drafter_logits(d_cache, toks[-1]))
            d_cache.offset.copy_(before + act)
            toks.append(e.sampler(logits[-1], sp, gen))
        d_cache.offset.copy_(d_next)
        draft_toks = torch.stack(toks, dim=1)
        # 3. the target verifies [prev, d1..dk] at its per-row cursors
        prev = self.pending.gather(1, idx[:, None])[:, 0]
        seq = torch.cat([prev[:, None], draft_toks], dim=1)
        off0 = cache.offset.clone()
        pos = _rows_positions(off0.long() + self.deltas, B, k + 1)
        hidden = e.lm(e.lp, e.lm.embed(e.lp, seq), cache, pos)
        pt = batched_filtered_probs(e.lm.logits(e.lp, hidden).float(), sp)
        pd = batched_filtered_probs(torch.stack(logits, dim=1), sp)
        # 4. the walk and each committed token's logprob
        u, g = walk_noise(B, k, pt.shape[-1], gen, pt.device)
        out, n_acc = rejection_walk(pt, pd, draft_toks, u, g)
        lp = torch.log(pt.gather(2, out[..., None])[..., 0].clamp_min(1e-30))
        # 5. per-row rewind; the committed tokens are pending next round
        commit = n_acc + 1
        cache.offset.copy_(off0 + commit.to(torch.int32) * act)
        ar = torch.arange(k + 1, device=out.device)[None, :]
        keep = self.active[:, None]
        self.pending.copy_(torch.where(
            keep, torch.where(ar < commit[:, None], out, 0), self.pending))
        self.pend_len.copy_(torch.where(self.active, commit, self.pend_len))
        self.result.copy_(torch.cat([out.double(), lp.double(),
                                     n_acc[:, None].double()], dim=1))


class SpeculativeBatchGenerator(BatchGenerator):
    """Continuous batching with per-round batched draft / verify
    (reference batch.py:51).  The keyword arguments are BatchGenerator's;
    the drafter's cache is a bf16 `BatchKVCache` of the same slots and
    capacity.  `stats` is the reference's `SpecStats` over every row's
    rounds; `decode.stats` holds the round's captures, replays and
    fetches."""

    def __init__(self, model, drafter, num_draft: int = 4, **kwargs):
        # a verify round writes k + 1 positions past a row's cursor
        kwargs["block_size"] = max(kwargs.get("block_size", 0), num_draft + 1)
        validate_drafter_compatibility(model, drafter)
        if torch.device(drafter.device or "cpu") != torch.device(
                model.device or "cpu"):
            raise ValueError(f"drafter on {drafter.device}, target on "
                             f"{model.device}")
        super().__init__(model, **kwargs)
        self.drafter = drafter
        self.dlm = drafter.language_model
        self.k = num_draft
        self.d_cache = cache_lib.init_batch_cache(
            self.dlm.args.num_hidden_layers, self.B, self.dlm.n_kv_heads,
            self.dlm.head_dim, self.capacity, self.dtype, device=self.dev)
        self.decode = _BatchRounds(
            SpeculativeEngine(model, drafter, num_draft), self.cache,
            self.d_cache, self.params, self.gen, self.B)
        self.stats = SpecStats()
        self.uid_stats: Dict[Any, SpecStats] = {}
        self._removed_stats: Dict[Any, SpecStats] = {}

    # ----------------------------------------------------------- admission
    def _register(self, slot: int, req: BatchRequest, first_tok: int,
                  S: int) -> None:
        super()._register(slot, req, first_tok, S)
        self._drafter_admit(slot, np.asarray(req.input_ids))
        self.uid_stats[req.uid] = SpecStats()

    def _drafter_admit(self, slot: int, ids: np.ndarray) -> None:
        """Chunked drafter prefill of the prompt's ids at positions
        arange(S) into a one-row cache, copied into the drafter's slot in
        place (reference :90-117)."""
        dlp = self.drafter.params["language_model"]
        S = ids.shape[1]
        step = min(self.prefill_step, round_up(S, 256))
        S_pad = round_up(S, step)
        row = make_cache(self.drafter, 1, round_up(S_pad, 256), self.dtype,
                         device=self.dev)
        emb = self.dlm.embed(dlp, torch.from_numpy(
            ids.astype(np.int64)).to(self.dev))
        emb = F.pad(emb, (0, 0, 0, S_pad - S))
        pos = torch.arange(S_pad, device=self.dev)
        pos = torch.where(pos < S, pos, 0)[None, None].expand(3, 1, S_pad)
        for c0 in range(0, S_pad, step):
            self.dlm(dlp, emb[:, c0:c0 + step], row, pos[:, :, c0:c0 + step])
            self.decode.stats["drafter_chunks"] += 1
        cache_lib.insert_row(self.d_cache, row, slot, S)

    def _free(self, slot: int) -> None:
        super()._free(slot)
        self.d_cache.offset[slot] = 0

    def remove(self, uid) -> None:
        super().remove(uid)
        st = self.uid_stats.pop(uid, None)
        if st is not None:
            # kept for pop_stats: the server records metrics after remove()
            self._removed_stats[uid] = st
            while len(self._removed_stats) > 4 * self.B:
                self._removed_stats.pop(next(iter(self._removed_stats)))

    def pop_stats(self, uid) -> Optional[SpecStats]:
        """One-shot per-request acceptance stats (the server's metrics)."""
        st = self.uid_stats.pop(uid, None)
        return st if st is not None else self._removed_stats.pop(uid, None)

    # ------------------------------------------------------------ scheduling
    def next(self) -> Dict[Any, List[Tuple[int, float]]]:
        """One scheduling cycle: admissions, then one round of every live
        row -> {uid: [(token, logprob), ...]} newly produced.  A queued
        request without `input_ids` is dropped and raises ValueError before
        any work."""
        if any(r.input_ids is None for r in self.queue):
            self.queue = [r for r in self.queue if r.input_ids is not None]
            raise ValueError("speculative serving needs BatchRequest."
                             "input_ids for the drafter prompt prefill")
        out = self._admit_and_first()
        if not self.active.any():
            return out
        self._push()
        tic = time.perf_counter()
        res = self.decode.run()
        self.decode.stats["decode_s"] += time.perf_counter() - tic
        k = self.k
        toks = res[:, :k + 1].astype(np.int64)
        lps = res[:, k + 1:2 * k + 2].astype(np.float32)
        n_acc = res[:, 2 * k + 2].astype(np.int64)
        for i, s in enumerate(self.slots):
            if s is None or not self.active[i]:
                continue
            uid = s.req.uid
            n = int(n_acc[i])
            self.stats.add(k, n)
            if uid in self.uid_stats:
                self.uid_stats[uid].add(k, n)
            for t in range(n + 1):
                tok = int(toks[i, t])
                out.setdefault(uid, []).append((tok, float(lps[i, t])))
                s.generated += 1
                if tok in s.req.eos_ids or s.generated >= s.req.max_tokens:
                    s.done = True
                    break
            if s.done:
                self._free(i)
        return out
