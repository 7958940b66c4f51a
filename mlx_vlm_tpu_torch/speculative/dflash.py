"""DFlash speculative decoding round loop.

Port of mlx_vlm_tpu/speculative/dflash.py (DFlashStats :32,
dflash_generate_step :46): the drafter drafts a whole block in one
non-autoregressive forward, the target verifies [bonus, d1..dk] through
`forward_captured`, the greedy walk commits 0..k drafts and the bonus,
and both caches rewind by their device cursors.  The block size adapts to
acceptance (`next_block_size`, sizes in {4, 8, ceiling}); each block size
has its own round (`DFlashRounds`), captured once on the card, as the
reference's `verify_fns` holds one program per size (:107-131).
"""

from __future__ import annotations

import dataclasses
from typing import Generator, Optional, Tuple

import numpy as np
import torch

from ..generate.ar import CACHE_BUCKET, make_cache
from ..generate.common import round_up
from .drafters.dflash import DFlashDrafter, next_block_size
from .utils import (CapturedRounds, SpecStats, captured_prefill, greedy_walk,
                    text_positions)

__all__ = ["DFlashStats", "DFlashRounds", "dflash_generate_step"]

# The last request's rounds ({block size: DFlashRounds}), held until the
# next request starts
last_rounds = None


@dataclasses.dataclass
class DFlashStats(SpecStats):
    """SpecStats and the recent (accepted, drafted) window that the
    adaptive block-size policy reads (reference accept_lens /
    draft_lens)."""

    def __post_init__(self):
        self.recent: list = []

    def record(self, accepted: int, drafted: int) -> None:
        self.rounds += 1
        self.drafted += drafted
        self.accepted += accepted
        self.recent.append((accepted, drafted))


class DFlashRounds(CapturedRounds):
    """One block size's round on device state shared by every size: the
    last committed token `tok` [1] and both caches with their 0-dim
    cursors.  The block draft from `tok`, the target's `forward_captured`
    over [tok, d1..dk] (k = block size - 1) at text positions, the greedy
    walk (n_acc in 0..k with the bonus), the target's cursor rewound to
    cursor + n_acc + 1, and the drafter's context appended with the
    k + 1 captured rows, its cursor advanced by n_acc + 1.  `result`
    [1, k + 2]: the round's k + 1 tokens, then n_acc."""

    def __init__(self, model, drafter: DFlashDrafter, params: dict, cache,
                 d_cache, tok: torch.Tensor, block_size: int,
                 gen: torch.Generator):
        super().__init__(tok.device, gen, (1, block_size + 1))
        self.model, self.drafter, self.params = model, drafter, params
        self.lm = model.language_model
        self.cache, self.d_cache, self.tok = cache, d_cache, tok
        self.k = block_size - 1
        self.draft = drafter.draft_fn(self.lm, block_size)
        self.append = drafter.append_fn(block_size)

    def round(self) -> None:
        k, lm = self.k, self.lm
        lp = self.model.params["language_model"]
        d_toks = self.draft(self.model.params, self.params, self.d_cache,
                            self.tok)
        seq = torch.cat([self.tok[:, None], d_toks], dim=1)
        hidden, hiddens = lm.forward_captured(
            lp, lm.embed(lp, seq), self.cache,
            text_positions(self.cache.offset, k + 1))
        greedy = torch.argmax(lm.logits(lp, hidden).float(), dim=-1)
        out, n_acc = greedy_walk(greedy, d_toks)
        acc = n_acc.max().to(torch.int32)
        self.cache.offset.add_(acc - k)
        # the drafter's context: the hiddens of [tok, d1..d_{n_acc}] are
        # the committed rows (reference hidden[:, :accepted + 1])
        self.append(self.params, self.d_cache, self.drafter.fuse_ctx(hiddens),
                    acc + 1)
        self.tok.copy_(out.gather(1, n_acc[:, None])[:, 0])
        self.result.copy_(torch.cat([out, n_acc[:, None]], dim=1))


def dflash_generate_step(
    inputs_embeds: torch.Tensor,  # [1, S, D]
    model,
    drafter: DFlashDrafter,
    drafter_params: dict,
    *,
    max_tokens: int = 256,
    draft_block_size: Optional[int] = None,
    adaptive: bool = True,
    stats: Optional[DFlashStats] = None,
) -> Generator[Tuple[np.ndarray, np.ndarray], None, None]:
    """Greedy DFlash speculative decoding, B = 1 (reference :46): yields
    (token [1], zeros [1]) numpy pairs, the target's plain greedy decode.

    The target's prompt goes through `forward_captured` in one chunk and
    its captured rows seed the drafter's context.  Each round's block size
    is `next_block_size` of the recent acceptance (`adaptive`) or the
    ceiling, cut to the tokens left (at least 2).  Both caches hold
    round_up(S + max_tokens + ceiling + 2, 256) rows in the embeddings'
    dtype.  One host fetch a round; `last_rounds` holds the request's
    rounds by block size."""
    B, S, _ = inputs_embeds.shape
    if B != 1:
        raise ValueError("the DFlash path is single-stream")
    global last_rounds
    stats = stats if stats is not None else DFlashStats()
    dev, dt = inputs_embeds.device, inputs_embeds.dtype
    lm, lp = model.language_model, model.params["language_model"]
    ceiling = draft_block_size or drafter.config.block_size
    capacity = round_up(S + max_tokens + ceiling + 2, CACHE_BUCKET)
    cache = make_cache(model, B, capacity, dt, device=dev)
    d_cache = drafter.init_cache(B, capacity, dt, device=dev)
    logits, hiddens = captured_prefill(lm, lp, inputs_embeds, cache)
    drafter.append_fn(S)(drafter_params, d_cache, drafter.fuse_ctx(hiddens),
                         S)
    tok = torch.argmax(logits, dim=-1)
    rounds = last_rounds = {}
    gen = torch.Generator(device=dev)
    yield tok.cpu().numpy(), np.zeros((B,), np.float32)
    n = 1
    while n < max_tokens:
        bs = (next_block_size(stats, ceiling, max_tokens - n + 1)
              if adaptive else min(ceiling, max_tokens - n + 1))
        bs = max(bs, 2)
        k = bs - 1
        if bs not in rounds:
            rounds[bs] = DFlashRounds(model, drafter, drafter_params, cache,
                                      d_cache, tok, bs, gen)
        res = rounds[bs].run()[0]
        n_acc = int(res[k + 1])
        stats.record(n_acc, k)
        for t in res[:n_acc + 1].astype(np.int64):
            if n >= max_tokens:
                break
            yield np.asarray([t]), np.zeros((B,), np.float32)
            n += 1
