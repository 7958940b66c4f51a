"""Server generation engine: one thread owns the card, over the batch engine.

Port of mlx_vlm_tpu/server/engine.py (PromptTooLongError :27,
GenerationArguments :31, StreamingToken :55, ServerMetricsStore :64,
ResponseGenerator :95).  Every piece of device work runs on the
generator's own thread ("gpu-owner"): embedding, the vision tower through
the vision-feature cache and the position ids (`_prepare`), the
schema-constrained requests (`_run_constrained`) and the batch's
`insert`, `next` and `remove`.  The HTTP handler threads only tokenize,
apply templates and queue.  So the batch's decode step, captured once per
generator as a CUDA graph (generate/batch.py `_SlotBlocks`) on this
thread, never sees another thread's CUDA call during its capture, and
every served request replays it: a request pays no capture of its own.

The scheduling loop (`_run`) copies the reference's: admission before
decode, cancellations, the host-side stop-sequence scan with its tail,
length exhaustion and the metrics envelope (`ttft_s`, `generation_tps`).
A structured-output request (`response_format` json_object / json_schema)
runs alone on the owner thread while the batch's rows wait, through
generate/ar.py's route for host samplers: every step eager (on the fused
route one K3 launch a step), the JSON automaton picking each token on the
host (structured.py).  Its metrics envelope carries `request_id`, `ttft_s`
and `generation_tps` as a batch request's does (the reference's has only
the token counts).  Automatic prefix caching (`apc`, an
apc.APCManager): `_prepare` looks the prompt up, restores its cached
prefix into a warm one-row cache and sets the harvest, all on the owner
thread and outside any capture, so every APC request takes the batch's
single-row admission.  Speculative serving (`draft_model`, the
reference's :140-150): the batch is a SpeculativeBatchGenerator, whose
round (catch-up, drafts, verify, walk) is captured once per generator on
this thread and replayed for every request; the drafter's admission runs
here too, and /metrics' envelope carries each request's "speculative"
acceptance (`pop_stats`).  With `kv_bits` it warns, as the reference
does, and serves bf16 caches.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger("mlx_vlm_tpu_torch.server")


class PromptTooLongError(ValueError):
    pass


@dataclasses.dataclass
class GenerationArguments:
    """Normalized request (reference generation.py:669)."""

    prompt: str = ""
    images: List[Any] = dataclasses.field(default_factory=list)
    audios: List[Any] = dataclasses.field(default_factory=list)
    max_tokens: int = 512
    temperature: float = 0.0
    top_p: float = 0.0
    min_p: float = 0.0
    top_k: int = -1
    stop: List[str] = dataclasses.field(default_factory=list)
    seed: Optional[int] = None
    # OpenAI response_format: {"type": "json_object"} or
    # {"type": "json_schema", "json_schema": {"schema": {...}}}
    response_format: Optional[dict] = None
    request_id: str = ""

    def __post_init__(self):
        if not self.request_id:
            self.request_id = uuid.uuid4().hex


@dataclasses.dataclass
class StreamingToken:
    token: Optional[int]
    text: str = ""
    logprob: float = 0.0
    finish_reason: Optional[str] = None
    error: Optional[str] = None


class ServerMetricsStore:
    """Rolling request metrics (reference generation.py:407)."""

    def __init__(self, history: int = 256):
        self.lock = threading.Lock()
        self.requests: List[dict] = []
        self.history = history
        self.started = time.time()
        self.total_prompt_tokens = 0
        self.total_generation_tokens = 0

    def record(self, env: dict):
        with self.lock:
            self.requests.append(env)
            self.total_prompt_tokens += env.get("prompt_tokens", 0)
            self.total_generation_tokens += env.get("generation_tokens", 0)
            if len(self.requests) > self.history:
                self.requests = self.requests[-self.history :]

    def envelope(self, request_id: str) -> dict:
        """The newest envelope recorded for `request_id` ({} when there is
        none): each finished request reads its own, not the newest one."""
        with self.lock:
            for env in reversed(self.requests):
                if env.get("request_id") == request_id:
                    return env
        return {}

    def snapshot(self) -> dict:
        with self.lock:
            recent = self.requests[-20:]
            return {
                "uptime_s": time.time() - self.started,
                "requests_total": len(self.requests),
                "total_prompt_tokens": self.total_prompt_tokens,
                "total_generation_tokens": self.total_generation_tokens,
                "recent": recent,
            }


def _param_dtype(params) -> torch.dtype:
    """The first floating-point tensor's dtype among the model's plain
    parameters (dict keys in sorted order, as the reference's tree_leaves
    walks them), bfloat16 when there is none.  Quantized weights are
    passed over: their scales keep a dtype of their own (f32 for the
    grouped int4 layout), not the model's."""
    stack = [params]
    while stack:
        node = stack.pop(0)
        if isinstance(node, torch.Tensor):
            if node.is_floating_point():
                return node.dtype
        elif isinstance(node, dict):
            stack = [node[k] for k in sorted(node)] + stack
        elif isinstance(node, (list, tuple)):
            stack = list(node) + stack
    return torch.bfloat16


class ResponseGenerator:
    """Owns the card; all device work happens on this one thread."""

    def __init__(
        self,
        model,
        processor,
        num_slots: int = 8,
        capacity: int = 4096,
        block_size: int = 8,
        max_context: Optional[int] = None,
        token_queue_timeout: float = 600.0,
        apc=None,
        vision_cache=None,
        draft_model=None,
        num_draft: int = 4,  # drafted tokens a round: draft_model only
        kv_bits: Optional[int] = None,
        kv_group_size: int = 64,
    ):
        from ..generate.batch import BatchGenerator
        from ..generate.dispatch import _get_eos_ids

        if draft_model is not None and kv_bits:
            logger.warning(
                "--kv-bits is not supported with --draft-model yet; "
                "serving with full-precision KV")
            kv_bits = None
        self.model = model
        self.processor = processor
        self.vision_cache = vision_cache
        self.apc = apc
        self.kv_bits, self.kv_group_size = kv_bits, kv_group_size
        self.eos_ids = tuple(_get_eos_ids(model, processor))
        self.max_context = max_context or capacity
        self.capacity = capacity
        self.token_queue_timeout = token_queue_timeout
        dtype = _param_dtype(model.params)
        if draft_model is not None:
            from ..speculative.batch import SpeculativeBatchGenerator

            self.batch = SpeculativeBatchGenerator(
                model, draft_model, num_draft=num_draft,
                num_slots=num_slots, capacity=capacity,
                block_size=block_size, dtype=dtype,
            )
        else:
            # quantized serving KV (reference BatchQuantizedKVCache):
            # kv_bits 4 / 8 select the per-row int4 / int8 batch caches
            # (K6 at 4 bits)
            self.batch = BatchGenerator(
                model, num_slots=num_slots, capacity=capacity,
                block_size=block_size, dtype=dtype,
                kv_bits=kv_bits, kv_group_size=kv_group_size,
            )
        self.metrics = ServerMetricsStore()
        self._requests: "queue.Queue" = queue.Queue()
        self._cancel: set = set()
        self._cancel_lock = threading.Lock()
        self._queues: Dict[str, "queue.Queue[StreamingToken]"] = {}
        self._meta: Dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gpu-owner")
        self._thread.start()

    # ------------------------------------------------------------ user side
    def generate(self, args: GenerationArguments):
        """Enqueue; returns an iterator of StreamingToken."""
        q: "queue.Queue[StreamingToken]" = queue.Queue()
        self._queues[args.request_id] = q
        self._requests.put(args)

        timeout = self.token_queue_timeout

        def it():
            try:
                while True:
                    try:
                        tok = q.get(timeout=timeout)
                    except queue.Empty:
                        yield StreamingToken(
                            token=None, finish_reason="error",
                            error="token queue timeout",
                        )
                        return
                    yield tok
                    if tok.finish_reason is not None or tok.error:
                        return
            finally:
                self._queues.pop(args.request_id, None)

        return it()

    def cancel(self, request_id: str):
        with self._cancel_lock:
            self._cancel.add(request_id)

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=10)

    # ------------------------------------------------------------ owner thread
    def _prepare(self, args: GenerationArguments):
        from ..generate.batch import BatchRequest, SamplingParams
        from ..generate.common import embed_prompt
        from ..utils.processing import prepare_inputs

        inputs = prepare_inputs(
            self.processor, args.prompt, images=args.images or None,
            audios=args.audios or None,
        )
        ids = np.asarray(inputs["input_ids"])
        if ids.shape[1] + args.max_tokens > self.max_context:
            if ids.shape[1] >= self.max_context:
                raise PromptTooLongError(
                    f"prompt has {ids.shape[1]} tokens; context budget is "
                    f"{self.max_context}"
                )
            args.max_tokens = self.max_context - ids.shape[1]
        embeds, pos, deltas = embed_prompt(self.model, inputs,
                                           self.vision_cache)
        prompt_cache, prefix_len, harvest = self._apc(inputs, embeds.dtype)
        self._meta[args.request_id] = {
            "prompt_tokens": int(ids.shape[1]),
            "t_submit": time.time(),
            "t_first": None,
            "generated": 0,
            "detok": self._make_detok(),
            "stop": args.stop,
            "tail": "",
        }
        return BatchRequest(
            uid=args.request_id,
            inputs_embeds=embeds,
            max_tokens=args.max_tokens,
            position_ids=pos,
            rope_delta=int(deltas[0, 0]),
            sampling=SamplingParams(
                temp=args.temperature, top_p=args.top_p,
                min_p=args.min_p, top_k=args.top_k,
            ),
            eos_ids=self.eos_ids,
            prompt_cache=prompt_cache,
            prefix_len=prefix_len,
            prompt_cache_callback=harvest,
            input_ids=ids,
        )

    def _apc(self, inputs: dict, dtype) -> tuple:
        """The reference's APC step of `_prepare` (:273-300), on the owner
        thread: the longest cached prefix's blocks restored into a warm
        one-row cache of round_up(S + 65, 256) rows (also at prefix 0, so
        that every request takes the single-row admission), and the
        harvest that commits the prompt's blocks.  Returns (warm cache,
        prefix length, harvest), or (None, 0, None) without APC or when
        the batch's cache is not a block cache (`model_apc_mode` for
        `kv_bits`): the reference builds a bf16 warm cache there too, and
        its admission fails copying it into the quantized batch cache.
        `model_apc_mode` is None also for a decoder with a bidirectional
        prefix, whose cached rows would carry another prompt's text."""
        from ..apc import prompt_key
        from ..apc_adapters import model_apc_mode
        from ..generate.common import round_up

        if self.apc is None or model_apc_mode(
                self.model, self.kv_bits, self.kv_group_size) != "block":
            return None, 0, None
        tokens, extra = prompt_key(self.model, inputs)
        prefix_len, blocks = self.apc.lookup(tokens, extra)
        try:
            warm = self.apc.make_warm_cache(
                blocks, self.model, round_up(len(tokens) + 65, 256), dtype)
        finally:
            self.apc.release(blocks)

        def harvest(cache):
            self.apc.commit(tokens, cache, extra, upto=len(tokens))

        return warm, prefix_len, harvest

    def _make_detok(self):
        from ..utils.tokenizer import make_detokenizer

        tok = getattr(self.processor, "tokenizer", self.processor)
        return make_detokenizer(tok, skip_special_tokens=True)

    def _run_constrained(self, args: GenerationArguments):
        """Schema-constrained generation for one request (OpenAI
        response_format json_object / json_schema): generate_step with the
        automaton's host sampler, every step eager (generate/ar.py's route
        for host samplers), tokens streamed into the request queue like any
        batch row."""
        from ..generate.ar import generate_step
        from ..generate.common import embed_prompt
        from ..structured import (_openness, build_json_schema_logits_processor,
                                  force_complete, json_complete,
                                  make_constrained_sampler, schema_complete)
        from ..utils.processing import prepare_inputs

        t_submit = time.time()
        rf = args.response_format or {}
        # json_object still means "a JSON OBJECT" (OpenAI semantics), so the
        # schema-less mode gets an object root rather than any JSON value
        schema = {"type": "object"}
        if rf.get("type") == "json_schema":
            js = rf.get("json_schema") or {}
            schema = js.get("schema") or js or schema
        tok = getattr(self.processor, "tokenizer", self.processor)
        proc = build_json_schema_logits_processor(schema, tok)
        sampler = make_constrained_sampler(proc)
        q = self._queues.get(args.request_id)
        inputs = prepare_inputs(self.processor, args.prompt,
                                images=args.images or None)
        ids = np.asarray(inputs["input_ids"])
        if ids.shape[1] + args.max_tokens > self.max_context:
            args.max_tokens = max(1, self.max_context - ids.shape[1])
        embeds, pos, deltas = embed_prompt(self.model, inputs,
                                           self.vision_cache)
        n = 0
        sent = 0
        finish = "length"
        t_first = None
        # the automaton's text is the authoritative constrained output;
        # generate_step runs one step ahead of its yields, so the emitted
        # stream tracks proc.text diffs, not the detokenizer
        for t, lp in generate_step(embeds, self.model, position_ids=pos,
                                   rope_deltas=deltas,
                                   max_tokens=args.max_tokens,
                                   sampler=sampler, block_size=1):
            tid = int(np.asarray(t).reshape(-1)[0])
            n += 1
            t_first = t_first or time.time()
            # flip the automaton into close-out mode once the remaining
            # budget barely covers closing the open structures (each level
            # can cost a few byte-level tokens, plus key->value detours)
            if (proc.close_after is None
                    and args.max_tokens - n
                    <= 4 * _openness(proc.text) + 4):
                proc.close_after = 0
            if tid in self.eos_ids:
                finish = "stop"
                break
            if q:
                new = proc.text[sent:]
                sent += len(new)
                q.put(StreamingToken(token=tid, text=new))
            if proc.done:
                finish = "stop"
                break
        final_text = proc.text
        if not proc.done:
            # run ended mid-document (length budget, or an EOS the deadlock
            # guard let through): append the grammar-forced completion
            # (structured.force_complete) so the client always receives one
            # valid schema-satisfying document
            final_text = force_complete(proc.text, schema)
            if (schema_complete(final_text, schema) if schema
                    else json_complete(final_text)):
                finish = "stop"
        tail = final_text[sent:]
        now = time.time()
        decode_s = now - (t_first or now)
        self.metrics.record({"request_id": args.request_id,
                             "prompt_tokens": int(ids.shape[1]),
                             "generation_tokens": n,
                             "ttft_s": (t_first or now) - t_submit,
                             "generation_tps": ((n - 1) / decode_s
                                                if decode_s > 1e-6 else 0.0),
                             "constrained": True})
        if q:
            q.put(StreamingToken(token=None, text=tail,
                                 finish_reason=finish))

    def _run(self):
        while not self._stop.is_set():
            # admit queued HTTP requests
            try:
                args = self._requests.get(
                    timeout=0.005 if self.batch.num_active or self.batch.queue else 0.2
                )
            except queue.Empty:
                args = None
            if args is not None:
                with self._cancel_lock:
                    cancelled = args.request_id in self._cancel
                    self._cancel.discard(args.request_id)
                if cancelled:
                    continue
                rf = args.response_format or {}
                if str(rf.get("type", "")).startswith("json"):
                    # structured outputs run a dedicated host-stepped
                    # constrained loop on the owner thread (the batch's
                    # captured step has no per-token host hook); concurrent
                    # rows resume after — correctness over throughput for
                    # the rare schema-constrained request
                    try:
                        self._run_constrained(args)
                    except Exception as e:  # noqa: BLE001
                        logger.exception("constrained generate failed")
                        q = self._queues.get(args.request_id)
                        if q:
                            q.put(StreamingToken(
                                token=None, finish_reason="error",
                                error=str(e)))
                    continue
                try:
                    req = self._prepare(args)
                    self.batch.insert(req)
                except Exception as e:  # noqa: BLE001
                    logger.exception("prepare failed")
                    q = self._queues.get(args.request_id)
                    if q:
                        q.put(StreamingToken(token=None, finish_reason="error",
                                             error=str(e)))
                continue  # admit any further queued requests before decoding

            # drain cancellations
            with self._cancel_lock:
                for rid in list(self._cancel):
                    self.batch.remove(rid)
                    self._meta.pop(rid, None)
                    self._cancel.clear()

            if not (self.batch.num_active or self.batch.queue):
                continue
            try:
                produced = self.batch.next()
            except Exception as e:  # noqa: BLE001
                logger.exception("batch step failed")
                for rid, q in list(self._queues.items()):
                    q.put(StreamingToken(token=None, finish_reason="error",
                                         error=str(e)))
                continue
            now = time.time()
            for rid, toks in produced.items():
                meta = self._meta.get(rid)
                q = self._queues.get(rid)
                if meta is None:
                    continue
                if meta["t_first"] is None:
                    meta["t_first"] = now
                finished = False
                last = None  # the finishing token, queued after its envelope
                for tok, lp in toks:
                    meta["generated"] += 1
                    is_eos = tok in self.eos_ids
                    text = ""
                    if not is_eos:
                        meta["detok"].add_token(tok)
                        text = meta["detok"].last_segment()
                    # stop-sequence scan (host-side): trim emitted text at
                    # the match point; keep enough tail history for stop
                    # strings that straddle segment boundaries.
                    stop_hit = None
                    if meta["stop"] and text:
                        prev_tail = meta["tail"]
                        combined = prev_tail + text
                        for s in meta["stop"]:
                            idx = combined.find(s)
                            if idx != -1:
                                stop_hit = s
                                text = text[: max(0, idx - len(prev_tail))]
                                break
                        keep = max(len(s) for s in meta["stop"]) - 1
                        meta["tail"] = combined[len(combined) - keep:] if keep > 0 else ""
                    finish = None
                    if is_eos:
                        finish = "stop"
                    elif stop_hit:
                        finish = "stop"
                        self.batch.remove(rid)
                    out = StreamingToken(token=None if is_eos else tok,
                                         text=text, logprob=lp,
                                         finish_reason=finish)
                    if finish:
                        last = out
                        finished = True
                        break
                    if q:
                        q.put(out)
                still_active = any(
                    s is not None and s.req.uid == rid for s in self.batch.slots
                ) or any(r.uid == rid for r in self.batch.queue)
                if not finished and not still_active:
                    # length exhausted
                    last = StreamingToken(token=None,
                                          text=meta["detok"].finalize(),
                                          finish_reason="length")
                    finished = True
                if finished:
                    decode_s = now - (meta["t_first"] or now)
                    env = {
                        "request_id": rid,
                        "prompt_tokens": meta["prompt_tokens"],
                        "generation_tokens": meta["generated"],
                        "ttft_s": (meta["t_first"] or now) - meta["t_submit"],
                        # tokens after the first, over decode wall time; 0 when
                        # everything landed in a single scheduler cycle
                        "generation_tps": (
                            (meta["generated"] - 1) / decode_s
                            if decode_s > 1e-6
                            else 0.0
                        ),
                    }
                    pop_stats = getattr(self.batch, "pop_stats", None)
                    st = pop_stats(rid) if pop_stats is not None else None
                    if st is not None and st.rounds:
                        env["speculative"] = {
                            "rounds": st.rounds,
                            "drafted": st.drafted,
                            "accepted": st.accepted,
                            "acceptance_rate": round(st.acceptance_rate, 4),
                        }
                    # recorded before the finishing token is queued, so
                    # that the handler finds its own envelope
                    self.metrics.record(env)
                    self._meta.pop(rid, None)
                    if q:
                        q.put(last)
