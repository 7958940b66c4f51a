"""DDTree best-first draft-tree construction and tree verification.

Port of mlx_vlm_tpu/speculative/ddtree.py (DDTreeNode :26, build_ddtree
:35, tree_ancestor_mask :89, walk_tree :101, tree_generate_step :117,
_pad_rows :223, _tree_forward :234).  The tree's construction, mask and
walk are host numpy, copied as they are.  A round: the DFlash drafter's
block logits (one host read) feed `build_ddtree`; one target forward over
[bonus | tree] (`forward_masked`: the tree's rows attend to the cache
below the cursor and to their ancestors, and write nothing) scores every
node; the host walk commits the deepest greedy-consistent path; a replay
forward (`forward_captured`) writes the committed path's K/V
contiguously at the cursor and yields the next bonus and the drafter's
context rows.

On the card the tree forward is captured once per tree width
(`TreeForward`, 1 + budget rows: the tree's tokens, depths and mask are
copied into its static inputs before each replay); the replay forward and
the drafter's draft and append run eagerly, as their lengths follow the
walk.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Generator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..generate.ar import CACHE_BUCKET, make_cache
from ..generate.common import round_up
from .utils import CapturedRounds, captured_prefill, text_positions

__all__ = ["DDTreeNode", "build_ddtree", "tree_ancestor_mask", "walk_tree",
           "TreeForward", "tree_generate_step"]

# The last request's tree forwards ({width: TreeForward}), held until the
# next request starts
last_rounds = None


@dataclasses.dataclass
class DDTreeNode:
    ranks: Tuple[int, ...]
    token_ids: Tuple[int, ...]
    log_prob: float
    depth: int
    parent: int = -1


def build_ddtree(drafter_logits: np.ndarray, budget: int,
                 slot_offset: int = 0) -> List[DDTreeNode]:
    """Best-first draft tree from per-depth marginals (Algorithm 1).

    drafter_logits: [L, V] (or [1, L, V]) logits of the block drafter, one
    row per draft depth.  Returns up to `budget` nodes in descending
    factorized log-probability; `parent` indexes earlier list entries
    (-1 = child of the root bonus token)."""
    logits = np.asarray(drafter_logits)
    if logits.ndim == 3:
        logits = logits[0]
    logits = logits[slot_offset:]
    L, V = logits.shape
    if L <= 0 or budget <= 0:
        return []
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1))
    log_probs = logits - logits.max(-1, keepdims=True) - lse[:, None]
    K = min(budget, V)
    top_ids = np.argsort(-log_probs, axis=-1)[:, :K]
    top_lp = np.take_along_axis(log_probs, top_ids, axis=-1)

    def lp_of(ranks):
        return float(sum(top_lp[d][r - 1] for d, r in enumerate(ranks)))

    heap: list = []
    counter = 0
    heapq.heappush(heap, (-lp_of((1,)), counter, (1,), -1))
    counter += 1
    tree: List[DDTreeNode] = []
    while heap and len(tree) < budget:
        neg_lp, _, ranks, parent = heapq.heappop(heap)
        depth = len(ranks)
        tokens = tuple(int(top_ids[d][r - 1]) for d, r in enumerate(ranks))
        idx = len(tree)
        tree.append(DDTreeNode(ranks, tokens, -neg_lp, depth, parent))
        if ranks[-1] + 1 <= K:  # next sibling
            nr = ranks[:-1] + (ranks[-1] + 1,)
            heapq.heappush(heap, (-lp_of(nr), counter, nr, parent))
            counter += 1
        if depth < L:  # first child
            nr = ranks + (1,)
            heapq.heappush(heap, (-lp_of(nr), counter, nr, idx))
            counter += 1
    return tree


def tree_ancestor_mask(tree: List[DDTreeNode]) -> np.ndarray:
    """[B+1, B+1] bool over [bonus | nodes]: row i sees its ancestors."""
    n = len(tree)
    m = np.eye(n + 1, dtype=bool)
    m[:, 0] = True  # everyone sees the bonus root
    for i, node in enumerate(tree):
        j = node.parent
        while j != -1:
            m[i + 1, j + 1] = True
            j = tree[j].parent
    return m


def walk_tree(tree: List[DDTreeNode], greedy: np.ndarray) -> List[int]:
    """Deepest greedy-consistent path.

    greedy[0] is the target's greedy token after the bonus; greedy[i+1]
    after tree node i.  Returns the accepted node indices root-to-leaf."""
    path: List[int] = []
    parent = -1
    want = int(greedy[0])
    while True:
        nxt = None
        for i, node in enumerate(tree):
            if node.parent == parent and node.token_ids[-1] == want:
                nxt = i
                break
        if nxt is None:
            return path
        path.append(nxt)
        parent = nxt
        want = int(greedy[nxt + 1])


class TreeForward(CapturedRounds):
    """The read-only target forward over [bonus | tree] (reference
    `_tree_forward` :234) at one width T: static inputs `seq` [1, T]
    (tokens), `depths` [T] and `amask` [T, T], written before each run;
    positions cursor + depth; `result` [1, T]: the target's greedy token
    after each row."""

    def __init__(self, model, cache, width: int, gen: torch.Generator):
        dev = cache.offset.device
        super().__init__(dev, gen, (1, width))
        self.lm, self.model, self.cache = model.language_model, model, cache
        self.seq = torch.zeros((1, width), dtype=torch.int64, device=dev)
        self.depths = torch.zeros((width,), dtype=torch.int64, device=dev)
        self.amask = torch.zeros((width, width), dtype=torch.bool, device=dev)

    def load(self, seq: np.ndarray, depths: np.ndarray,
             amask: np.ndarray) -> None:
        self.seq.copy_(torch.from_numpy(seq))
        self.depths.copy_(torch.from_numpy(depths))
        self.amask.copy_(torch.from_numpy(amask))

    def round(self) -> None:
        lm, lp = self.lm, self.model.params["language_model"]
        pos = (self.cache.offset.long() + self.depths)[None]
        hidden = lm.forward_masked(lp, lm.embed(lp, self.seq), self.cache,
                                   pos, self.amask)
        self.result.copy_(torch.argmax(lm.logits(lp, hidden).float(),
                                       dim=-1))


def _pad_rows(feats: torch.Tensor, width: int) -> torch.Tensor:
    T = feats.shape[1]
    if T == width:
        return feats
    if T > width:
        return feats[:, :width]
    return F.pad(feats, (0, 0, 0, width - T))


def tree_generate_step(
    inputs_embeds: torch.Tensor,  # [1, S, D]
    model,
    drafter,  # drafters.dflash.DFlashDrafter
    drafter_params: dict,
    *,
    max_tokens: int = 256,
    draft_block_size: Optional[int] = None,
    tree_budget: int = 8,
    stats=None,
) -> Generator[Tuple[np.ndarray, np.ndarray], None, None]:
    """Greedy tree-verified speculative decoding, B = 1 (reference :117;
    lossless): yields (token [1], zeros [1]) numpy pairs.

    Per round: the DFlash drafter's block logits feed build_ddtree; one
    target forward scores [bonus | tree]; the deepest greedy-consistent
    path commits; a replay forward writes the path's K/V contiguously and
    yields the next bonus and the drafter's context rows.  Both caches
    hold round_up(S + max_tokens + budget + depth + 2, 256) rows in the
    embeddings' dtype."""
    from .dflash import DFlashStats

    B, S, _ = inputs_embeds.shape
    if B != 1:
        raise ValueError("the DDTree path is single-stream")
    global last_rounds
    stats = stats if stats is not None else DFlashStats()
    dev, dt = inputs_embeds.device, inputs_embeds.dtype
    lm, lp = model.language_model, model.params["language_model"]
    bs = draft_block_size or drafter.config.block_size
    depth = bs - 1
    nb = tree_budget
    capacity = round_up(S + max_tokens + nb + depth + 2, CACHE_BUCKET)
    cache = make_cache(model, B, capacity, dt, device=dev)
    d_cache = drafter.init_cache(B, capacity, dt, device=dev)
    logits, hiddens = captured_prefill(lm, lp, inputs_embeds, cache)
    drafter.append_fn(S)(drafter_params, d_cache, drafter.fuse_ctx(hiddens),
                         S)
    tok = int(torch.argmax(logits, dim=-1)[0])
    yield np.asarray([tok]), np.zeros((B,), np.float32)
    n = 1
    forwards = last_rounds = {}
    gen = torch.Generator(device=dev)
    draft_logits = drafter.draft_logits_fn(lm, bs)
    append = drafter.append_fn(depth + 1)
    while n < max_tokens:
        bonus = torch.tensor([tok], dtype=torch.int64, device=dev)
        lgts = draft_logits(model.params, drafter_params, d_cache,
                            bonus).cpu().numpy()
        tree = build_ddtree(lgts[0], nb)
        seq = np.asarray([[tok] + [nd.token_ids[-1] for nd in tree]],
                         np.int64)
        depths = np.asarray([0] + [nd.depth for nd in tree], np.int64)
        width = seq.shape[1]
        if width not in forwards:
            forwards[width] = TreeForward(model, cache, width, gen)
        fwd = forwards[width]
        fwd.load(seq, depths, tree_ancestor_mask(tree))
        greedy = fwd.run()[0].astype(np.int64)
        path = walk_tree(tree, greedy)
        committed = [tree[i].token_ids[-1] for i in path]
        stats.record(len(committed), depth)
        # replay [bonus | path]: its K/V written at the cursor, the next
        # bonus from its last row, the drafter's context from its rows
        m = len(committed) + 1
        replay = torch.tensor([[tok] + committed], dtype=torch.int64,
                              device=dev)
        hidden, hiddens = lm.forward_captured(
            lp, lm.embed(lp, replay), cache, text_positions(cache.offset, m))
        nxt = int(torch.argmax(lm.logits(lp, hidden[:, -1:]).float(),
                               dim=-1)[0, 0])
        append(drafter_params, d_cache,
               _pad_rows(drafter.fuse_ctx(hiddens), depth + 1), m)
        for t in committed + [nxt]:
            if n >= max_tokens:
                return
            yield np.asarray([t]), np.zeros((B,), np.float32)
            n += 1
        tok = nxt
