"""Continuous batching engine.

Port of mlx_vlm_tpu/generate/batch.py (SamplingParams :39, BatchRequest
:47, BatchGenerator :71, _admit_one :184, _register :271, _admit_batch
:289, remove :384, next :421, batch_generate :467) and of the prefill
programs its admission runs (mlx_vlm_tpu/generate/ar.py
DecodeEngine._prefill :78, _prefill_rows :91: `prefill_rows` here).

Fixed batch slots and fixed-capacity per-row caches, as in the reference:
a new request is prefilled into a row cache of its own (its chunks'
linears on K1, its attention on K4 where `flash_eligible` holds), its
rows are copied IN PLACE into a free slot of the batch cache
(`insert_row`), and a finished request frees its slot.  The batch cache
has one cursor per row (`BatchKVCache`, or a quantized cache built with
`per_row=True`).  The per-row sampling parameters, the active mask, the
rope deltas, the last tokens and the token history are device tensors
that admission rewrites in place, so the decode step never changes: on
the card its first run is eager and the next is captured once per
generator as a CUDA graph (`ops/_cuda.Graph`), which every later step of
every request replays, across admissions and removals (generate/ar.py
`DecodeBlocks`: a block's replays under sync debug mode "error", its rows
in one pinned copy).  On the CPU the same step runs eagerly.  Idle rows
compute and are masked on the host; their cursors do not move, and a
freed slot's cursor is parked at 0.  Decode-first scheduling: admit
queued requests while slots are free (cold prompts in one batched
prefill when two or more wait), then run one block of `block_size`
steps.  Prefix caching: a request with a `prompt_cache` (apc.py's warm
cache, its cursor at `prefix_len`) takes the single-row admission and
prefills only its uncached suffix into that cache before the row is
copied into its slot; `prompt_cache_callback` gets the row's cache with
its cursor at the prompt's length (the harvest).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import cache as cache_lib
from ..core.sampling import make_batched_sampler
from ..utils.processing import prepare_inputs
from ..utils.tokenizer import make_detokenizer
from .ar import DecodeBlocks, check_kv_bits, make_cache
from .common import embed_prompt, refuse_prefix_reuse, round_up

DEFAULT_SLOTS = 8
DEFAULT_CAPACITY = 4096
DEFAULT_BLOCK = 8


@dataclasses.dataclass
class SamplingParams:
    temp: float = 0.0
    top_p: float = 0.0
    min_p: float = 0.0
    top_k: int = -1


@dataclasses.dataclass
class BatchRequest:
    uid: Any
    inputs_embeds: Any  # [1, S, D]
    max_tokens: int = 256
    position_ids: Optional[np.ndarray] = None  # [3, 1, S]
    rope_delta: int = 0
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    eos_ids: Tuple[int, ...] = ()
    # prefix caching: a one-row cache whose cursor is at prefix_len (apc.py
    # `make_warm_cache`), and the harvest hook (`APCManager.commit`)
    prompt_cache: Any = None
    prefix_len: int = 0
    prompt_cache_callback: Optional[Callable] = None
    # token ids [1, S], kept for speculative serving's drafter prefill
    input_ids: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Slot:
    req: BatchRequest
    generated: int = 0
    prompt_len: int = 0
    done: bool = False


def prefill_rows(model, cache, embeds: torch.Tensor,
                 position_ids: torch.Tensor,
                 last_idx: torch.Tensor) -> torch.Tensor:
    """One prefill chunk through the language model (its k/v written into
    `cache` in place, the cursor advanced) -> f32 logits [B, V] of row b at
    its position last_idx[b] of the chunk."""
    lm = model.language_model
    lp = model.params["language_model"]
    hidden = lm(lp, embeds, cache, position_ids)
    idx = last_idx.to(hidden.device, torch.int64).reshape(-1, 1, 1)
    h_last = hidden.gather(1, idx.expand(-1, 1, hidden.shape[2]))
    return lm.logits(lp, h_last)[:, 0].float()


class _SlotBlocks(DecodeBlocks):
    """`DecodeBlocks` over the generator's slots: each step samples every
    row with its own parameters (`params`, [B] device tensors), keeps the
    last token of the rows that `active` (bool [B]) marks idle, and takes
    the step back from their cursors.  `stats` also counts the captures
    (one per generator), the admissions (one per prefill program: a
    batched admission counts once), their prefill chunks and the chunks
    that ran the head, and `decode_s`, the host seconds of the blocks
    (dispatch to fetched rows); its `fetches` count the admissions'
    first-token reads beside the blocks."""

    def __init__(self, model, cache, sampler, params: dict,
                 active: torch.Tensor, gen, block_size: int):
        B = active.shape[0]
        deltas = torch.zeros((B,), dtype=torch.int64, device=active.device)
        super().__init__(model, cache, deltas,
                         lambda logits, g: sampler(logits, params, g), (),
                         gen, block_size)
        self.active = active
        self.stats.update(captures=0, admissions=0, prefill_chunks=0,
                          prefill_heads=0, decode_s=0.0)

    def pick(self, logits: torch.Tensor):
        logprobs = torch.log_softmax(logits, dim=-1)
        tok = torch.where(self.active, self.sampler(logits, self.gen),
                          self.tok)
        self.history.copy_(torch.cat([self.history[:, 1:], tok[:, None]],
                                     dim=1))
        self.tok.copy_(tok)
        return tok, logprobs.gather(1, tok[:, None])[:, 0]

    def step(self) -> None:
        super().step()
        self.cache.offset.sub_((~self.active).to(torch.int32))

    def admit(self, slot: int, first_tok: int) -> None:
        """A newly admitted row's last token and history, written on the
        device in place."""
        self.tok[slot] = first_tok
        self.history[slot] = -1
        self.history[slot, -1] = first_tok

    def _capture(self) -> None:
        super()._capture()
        self.stats["captures"] += 1


class BatchGenerator:
    """Fixed-slot continuous batching scheduler (reference batch.py:71).

    `kv_bits` picks a per-row quantized cache by generate/ar.py
    `make_cache` (a TurboQuant codebook cache raises: it has no per-row
    cursors); the default is a bf16 `BatchKVCache`.  Random draws come
    from one torch.Generator seeded 0 on the model's device."""

    def __init__(self, model, num_slots: int = DEFAULT_SLOTS,
                 capacity: int = DEFAULT_CAPACITY,
                 block_size: int = DEFAULT_BLOCK,
                 prefill_step_size: int = 512, dtype=torch.bfloat16,
                 kv_bits: Optional[float] = None, kv_group_size: int = 64):
        self.model = model
        self.lm = lm = model.language_model
        self.B = B = num_slots
        self.capacity = capacity
        self.block = block_size
        self.prefill_step = prefill_step_size
        self.dtype = dtype
        self.kv_bits = kv_bits
        self.kv_group_size = kv_group_size
        self.dev = dev = torch.device(model.device or "cpu")
        check_kv_bits(kv_bits)
        if kv_bits:
            self.cache = make_cache(model, B, capacity, dtype, kv_bits,
                                    kv_group_size, per_row=True, device=dev)
        else:
            self.cache = cache_lib.init_batch_cache(
                lm.args.num_hidden_layers, B, lm.n_kv_heads, lm.head_dim,
                capacity, dtype, device=dev)
        self._sampler = make_batched_sampler()
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)
        f32 = dict(dtype=torch.float32, device=dev)
        self.params = {"temp": torch.zeros((B,), **f32),
                       "top_p": torch.zeros((B,), **f32),
                       "min_p": torch.zeros((B,), **f32),
                       "top_k": torch.full((B,), -1, dtype=torch.int64,
                                           device=dev)}
        self.decode = _SlotBlocks(
            model, self.cache, self._sampler, self.params,
            torch.zeros((B,), dtype=torch.bool, device=dev), self.gen,
            block_size)
        self.stats = self.decode.stats
        self.slots: List[Optional[_Slot]] = [None] * B
        self.queue: List[BatchRequest] = []
        # host mirrors of the per-row device state, copied in place into
        # the captured tensors before a block when they changed
        self.temp = np.zeros(B, np.float32)
        self.top_p = np.zeros(B, np.float32)
        self.min_p = np.zeros(B, np.float32)
        self.top_k = -np.ones(B, np.int64)
        self.deltas = np.zeros(B, np.int64)
        self.active = np.zeros(B, bool)
        self._dirty = False
        self._first_tokens: Dict[Any, int] = {}

    # ------------------------------------------------------------ lifecycle
    def insert(self, req: BatchRequest) -> None:
        """Queue `req`; a warm one (`prompt_cache` at `prefix_len` > 0) is
        refused for a decoder with a bidirectional prefix
        (`refuse_prefix_reuse`)."""
        if req.prompt_cache is not None:
            refuse_prefix_reuse(self.model, req.prefix_len)
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _embeds(self, req: BatchRequest) -> torch.Tensor:
        return torch.as_tensor(req.inputs_embeds).to(self.dev, self.dtype)

    @staticmethod
    def _positions(req: BatchRequest, S: int) -> np.ndarray:
        """The request's position ids [3, 1, S] (arange without M-RoPE)."""
        if req.position_ids is None:
            return np.broadcast_to(np.arange(S, dtype=np.int64), (3, 1, S))
        return np.asarray(req.position_ids, np.int64)

    def _cap_tokens(self, req: BatchRequest, S: int) -> None:
        """Cap max_tokens so that every decode step of the row, the block
        it finishes in included, writes inside the capacity."""
        if S + req.max_tokens + self.block + 1 > self.capacity:
            req.max_tokens = max(0, self.capacity - S - self.block - 1)

    def _first(self, logits: torch.Tensor,
               reqs: List[BatchRequest]) -> np.ndarray:
        """First tokens of the admitted rows from their prefill logits, each
        with its own sampling parameters (rows past `reqs` greedy); one
        host fetch."""
        pad = logits.shape[0] - len(reqs)
        sp = [r.sampling for r in reqs]

        def col(name, fill, dtype):
            vals = [getattr(p, name) for p in sp] + [fill] * pad
            return torch.tensor(vals, dtype=dtype, device=self.dev)

        params = {"temp": col("temp", 0.0, torch.float32),
                  "top_p": col("top_p", 0.0, torch.float32),
                  "min_p": col("min_p", 0.0, torch.float32),
                  "top_k": col("top_k", -1, torch.int64)}
        toks = self._sampler(logits, params, self.gen).cpu().numpy()
        self.decode.stats["fetches"] += 1
        self.decode.stats["admissions"] += 1
        return toks

    def _prefill(self, cache, embeds: torch.Tensor, pos: np.ndarray,
                 last_idx: np.ndarray, step: int) -> torch.Tensor:
        """Chunked prefill of [n, S_pad] rows into `cache`; returns each
        row's logits [n, V] from the chunk holding its last token (the
        head runs only on chunks that hold one)."""
        chunks = {}
        for c0 in range(0, embeds.shape[1], step):
            pchunk = torch.from_numpy(
                np.ascontiguousarray(pos[:, :, c0:c0 + step])).to(self.dev)
            in_chunk = (last_idx >= c0) & (last_idx < c0 + step)
            self.decode.stats["prefill_chunks"] += 1
            if not in_chunk.any():
                self.lm(self.model.params["language_model"],
                        embeds[:, c0:c0 + step], cache, pchunk)
                continue
            idx = torch.from_numpy(np.where(in_chunk, last_idx - c0, 0))
            chunks[c0] = prefill_rows(self.model, cache,
                                      embeds[:, c0:c0 + step], pchunk, idx)
            self.decode.stats["prefill_heads"] += 1
        return torch.stack([chunks[(int(i) // step) * step][r]
                            for r, i in enumerate(last_idx)])

    def _admit_one(self) -> bool:
        free = self._free_slots()
        if not free or not self.queue:
            return False
        slot = free[0]
        req = self.queue.pop(0)
        embeds = self._embeds(req)
        S = embeds.shape[1]
        self._cap_tokens(req, S)
        # a warm request prefills its uncached suffix into its prompt
        # cache, unless the padded suffix would overwrite the prefix: then
        # the whole prompt, cold, into a fresh cache (reference :207-223)
        row_cache = req.prompt_cache
        prefix = req.prefix_len if row_cache is not None else 0
        step = min(self.prefill_step, round_up(S - prefix, 256))
        S_pad = round_up(S - prefix, step)
        if row_cache is not None:
            while prefix + S_pad > row_cache.capacity and step > 64:
                step = max(64, step // 2)
                S_pad = round_up(S - prefix, step)
            if prefix + S_pad > row_cache.capacity:
                row_cache, prefix = None, 0
                step = min(self.prefill_step, round_up(S, 256))
                S_pad = round_up(S, step)
        if row_cache is None:
            row_cache = make_cache(self.model, 1, round_up(S_pad, 256),
                                   self.dtype, self.kv_bits,
                                   self.kv_group_size, device=self.dev)
        suffix = S - prefix
        pos = np.zeros((3, 1, S_pad), np.int64)
        pos[:, :, :suffix] = self._positions(req, S)[:, :, prefix:]
        cache_lib.set_prompt_end(row_cache, S)
        logits = self._prefill(
            row_cache, F.pad(embeds[:, prefix:], (0, 0, 0, S_pad - suffix)),
            pos, np.array([suffix - 1]), step)
        row_cache.offset.fill_(S)
        if req.prompt_cache_callback is not None:
            req.prompt_cache_callback(row_cache)
        first = self._first(logits, [req])
        cache_lib.insert_row(self.cache, row_cache, slot, S)
        del row_cache
        self._register(slot, req, int(first[0]), S)
        return True

    def _admit_batch(self) -> bool:
        """Batched admission (reference :289): cold prompts (no prompt
        cache) right-padded to one chunked length, rows padded to a power
        of two, prefilled together, then inserted row by row; a request's
        harvest hook gets a one-row view of the prefilled cache, its
        cursor at the prompt's length."""
        free = self._free_slots()
        cold = [r for r in self.queue if r.prompt_cache is None]
        if len(free) < 2 or len(cold) < 2:
            return False
        reqs = cold[:min(len(free), 8)]
        embeds_l = [self._embeds(r) for r in reqs]
        lens = [e.shape[1] for e in embeds_l]
        S_pad = round_up(max(lens), 64)
        step = min(self.prefill_step, S_pad)
        S_pad = round_up(S_pad, step)
        if S_pad > self.capacity:
            return False  # a prompt past the capacity: admitted alone
        n = len(reqs)
        n_pad = 1 << (n - 1).bit_length()
        # rows of different widths (Qwen3-VL: a text prompt [1, S, D] beside
        # an image prompt's channel-packed deepstack [1, S, D * (1 + n_ds)])
        # share the widest layout; a narrower row's missing channels are
        # zeros, so that its layers' deepstack add is a no-op, as the
        # model's own packing does at text positions.  The reference sizes
        # every row from the first one's width and fails on such a batch.
        width = max(e.shape[2] for e in embeds_l)
        embeds = torch.zeros((n_pad, S_pad, width), dtype=self.dtype,
                             device=self.dev)
        pos = np.zeros((3, n_pad, S_pad), np.int64)
        for i, (r, e) in enumerate(zip(reqs, embeds_l)):
            embeds[i, :lens[i], :e.shape[2]] = e[0]
            pos[:, i, :lens[i]] = self._positions(r, lens[i])[:, 0]
        cache = make_cache(self.model, n_pad, round_up(S_pad, 256),
                           self.dtype, self.kv_bits, self.kv_group_size,
                           device=self.dev)
        last_idx = np.zeros(n_pad, np.int64)
        last_idx[:n] = np.asarray(lens) - 1
        cache_lib.set_prompt_end(cache, last_idx + 1)
        first = self._first(self._prefill(cache, embeds, pos, last_idx,
                                          step), reqs)
        for i, r in enumerate(reqs):
            self.queue.remove(r)
            slot = self._free_slots()[0]
            self._cap_tokens(r, lens[i])
            if r.prompt_cache_callback is not None:
                r.prompt_cache_callback(cache_lib.row_view(cache, i, lens[i]))
            cache_lib.insert_row(self.cache, cache, slot, lens[i], src_row=i)
            self._register(slot, r, int(first[i]), lens[i])
        return True

    def _register(self, slot: int, req: BatchRequest, first_tok: int,
                  S: int) -> None:
        """Post-prefill bookkeeping of a newly admitted row: its device state
        written in place (`decode.admit`), its parameters into the host
        mirrors."""
        self.decode.admit(slot, first_tok)
        sp = req.sampling
        self.temp[slot] = sp.temp
        self.top_p[slot] = sp.top_p
        self.min_p[slot] = sp.min_p
        self.top_k[slot] = sp.top_k
        self.deltas[slot] = req.rope_delta
        self.active[slot] = True
        self._dirty = True
        self.slots[slot] = _Slot(req=req, prompt_len=S, generated=1)
        # the first token counts as generated output
        self._first_tokens[req.uid] = first_tok

    def _free(self, slot: int) -> None:
        """Free a slot: idle from the next block on, its cursor parked at 0
        (a prompt longer than the capacity left it past the last row)."""
        self.slots[slot] = None
        self.active[slot] = False
        self._dirty = True
        self.cache.offset[slot] = 0

    def _push(self) -> None:
        """Copy the host mirrors into the captured tensors, in place."""
        if not self._dirty:
            return
        for name in ("temp", "top_p", "min_p", "top_k"):
            self.params[name].copy_(torch.from_numpy(getattr(self, name)))
        self.decode.deltas.copy_(torch.from_numpy(self.deltas))
        self.decode.active.copy_(torch.from_numpy(self.active))
        self._dirty = False

    def remove(self, uid) -> None:
        for i, s in enumerate(self.slots):
            if s is not None and s.req.uid == uid:
                self._free(i)
        self.queue = [r for r in self.queue if r.uid != uid]

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _admit_and_first(self) -> Dict[Any, List[Tuple[int, float]]]:
        """Admission phase: admit queued requests, return their first
        sampled tokens and free any slots those tokens finish."""
        out: Dict[Any, List[Tuple[int, float]]] = {}
        while self._admit_batch():
            pass
        while self._admit_one():
            pass
        for uid, t in self._first_tokens.items():
            out.setdefault(uid, []).append((t, 0.0))
        self._first_tokens = {}
        for i, s in enumerate(self.slots):
            if s and not s.done:
                last_tok = out.get(s.req.uid, [(None, 0)])[-1][0]
                if last_tok is not None and (
                        last_tok in s.req.eos_ids
                        or s.generated >= s.req.max_tokens):
                    s.done = True
                    self._free(i)
        return out

    def next(self) -> Dict[Any, List[Tuple[int, float]]]:
        """One scheduling cycle -> {uid: [(token, logprob), ...]} newly
        produced (an admitted request's first token included, with logprob
        0.0 as in the reference)."""
        out = self._admit_and_first()
        if not self.active.any():
            return out
        self._push()
        tic = time.perf_counter()
        pairs = list(self.decode.fetch(self.decode.dispatch(self.block)))
        self.decode.stats["decode_s"] += time.perf_counter() - tic
        toks_h = np.stack([t for t, _ in pairs], axis=1)  # [B, T]
        lps_h = np.stack([lp for _, lp in pairs], axis=1)
        for i, s in enumerate(self.slots):
            if s is None or not self.active[i]:
                continue
            uid = s.req.uid
            for t in range(toks_h.shape[1]):
                if s.generated >= s.req.max_tokens or s.done:
                    break
                tok = int(toks_h[i, t])
                out.setdefault(uid, []).append((tok, float(lps_h[i, t])))
                s.generated += 1
                if tok in s.req.eos_ids or s.generated >= s.req.max_tokens:
                    s.done = True
            if s.done:
                self._free(i)
        return out


@dataclasses.dataclass
class BatchResponse:
    texts: List[str]
    stats: dict
    # the BatchGenerator's `stats` (captures, replays, steps, blocks,
    # fetches, admissions, prefill chunks and heads; first-step, capture
    # and block seconds); the reference has no such field
    generator_stats: dict = dataclasses.field(default_factory=dict)


def detokenize(processor, ids: List[int], eos: Tuple[int, ...]) -> str:
    """One request's text from its generated ids, EOS ids left out."""
    detok = make_detokenizer(getattr(processor, "tokenizer", processor))
    for t in ids:
        if t not in eos:
            detok.add_token(t)
            detok.last_segment()
    return detok.text + detok.finalize()


def batch_generate(model, processor, prompts: List[str],
                   images: Optional[List[Any]] = None, max_tokens: int = 256,
                   temperature: float = 0.0, top_p: float = 0.0,
                   num_slots: int = DEFAULT_SLOTS,
                   capacity: int = DEFAULT_CAPACITY,
                   verbose: bool = False) -> BatchResponse:
    """Offline batched generation (reference batch.py:467).

    Each prompt is preprocessed, embedded (its image merged) and given its
    M-RoPE ids on its own (`embed_prompt`), then streamed through one
    BatchGenerator with a bf16 batch cache; texts come back in input
    order.  Unlike the reference, which swallows unknown keyword
    arguments, it takes no others."""
    from .dispatch import _get_eos_ids

    t_start = time.perf_counter()
    eos = tuple(_get_eos_ids(model, processor))
    imgs = images if images is not None else [None] * len(prompts)
    requests, total_prompt_tokens = [], 0
    for uid, (prompt, image) in enumerate(zip(prompts, imgs)):
        inputs = prepare_inputs(processor, prompt, images=image)
        total_prompt_tokens += np.asarray(inputs["input_ids"]).shape[1]
        embeds, pos, deltas = embed_prompt(model, inputs)
        requests.append(BatchRequest(
            uid=uid, inputs_embeds=embeds, max_tokens=max_tokens,
            position_ids=pos, rope_delta=int(deltas[0, 0]),
            sampling=SamplingParams(temp=temperature, top_p=top_p),
            eos_ids=eos))

    dtype = requests[0].inputs_embeds.dtype if requests else torch.bfloat16
    gen = BatchGenerator(model, num_slots=num_slots, capacity=capacity,
                         dtype=dtype)
    for req in requests:
        gen.insert(req)
    token_lists: Dict[int, List[int]] = {u: [] for u in range(len(prompts))}
    while gen.num_active or gen.queue:
        for uid, toks in gen.next().items():
            token_lists[uid].extend(t for t, _ in toks)

    texts = [detokenize(processor, token_lists[u], eos)
             for u in range(len(prompts))]
    total_gen = sum(len(v) for v in token_lists.values())
    wall = time.perf_counter() - t_start
    stats = {"prompt_tokens": total_prompt_tokens,
             "generation_tokens": total_gen,
             "generation_tps": total_gen / max(wall, 1e-9), "wall_s": wall}
    if verbose:
        print(f"Prompts: {len(prompts)}, {total_prompt_tokens} tokens; "
              f"generation: {total_gen} tokens, "
              f"{stats['generation_tps']:.3f} tokens-per-sec")
    return BatchResponse(texts=texts, stats=stats,
                         generator_stats=dict(gen.stats))
