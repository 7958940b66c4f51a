"""High-level generate / stream_generate.

Port of mlx_vlm_tpu/generate/dispatch.py (stream_generate :43, generate
:309) for the autoregressive image, video and text path.  `kv_bits` picks a
quantized KV cache (generate/ar.py make_cache); `block_size` is the number
of decode steps per host fetch (generate/ar.py `DecodeBlocks`: on the card
each step after the first replays one captured CUDA graph).  `apc`
reuses a cached prompt prefix (the reference's :148-194) and
`vision_cache` the vision tower's features.  `draft_model` decodes
speculatively with a vanilla drafter (speculative/utils.py
`speculative_generate_step`, the reference's :223-241).  `video` (a
path, which needs cv2, or frames; `fps` their rate) goes to the vision
tower and the M-RoPE ids of the Qwen-VL line (generate/common.py
`embed_prompt`), where the reference's embedding drops it (ROADMAP's
known faults in the reference); a model without a video token refuses
it, and `audio` raises NotImplementedError.
"""

from __future__ import annotations

import os
import time
from typing import Any, Generator, List, Optional, Union

import numpy as np

from ..core.sampling import make_logits_processors, make_sampler
from ..utils.processing import prepare_inputs
from ..utils.profiling import annotate, global_phases
from ..utils.tokenizer import make_detokenizer
from .ar import check_kv_bits, generate_step
from .common import (GenerationResult, device_peak_memory_gb, embed_prompt,
                     round_up)

__all__ = ["stream_generate", "generate"]


def _get_eos_ids(model, processor) -> set:
    eos = set()
    cfg = getattr(model, "config_dict", {}) or {}
    v = cfg.get("eos_token_id")
    if v is None and isinstance(cfg.get("text_config"), dict):
        v = cfg["text_config"].get("eos_token_id")
    if isinstance(v, int):
        eos.add(v)
    elif isinstance(v, (list, tuple)):
        eos.update(v)
    tok = getattr(processor, "tokenizer", processor)
    tid = getattr(tok, "eos_token_id", None)
    if tid is not None:
        eos.add(int(tid))
    return eos


def _apc_lookup(apc, model, inputs: dict, dtype, max_tokens: int,
                block_size: int, kv_bits, kv_group_size: int) -> tuple:
    """The reference's APC lookup (dispatch.py:148-194): (prompt cache or
    None, prefix length, the callback that stores the prompt)."""
    from ..apc import media_safe_prefix_min, prompt_key
    from ..apc_adapters import model_apc_mode

    tokens, extra = prompt_key(model, inputs)
    S = len(tokens)
    capacity = round_up(S + max_tokens + block_size + 65, 256)
    mode = model_apc_mode(model, kv_bits=kv_bits, kv_group_size=kv_group_size)
    if mode == "exact":
        guard = max(1, int(os.environ.get("APC_EXACT_PREFIX_GUARD_TOKENS",
                                          "16")))
        prefix_len, cache = apc.lookup_exact(
            tokens, extra,
            min_prefix_tokens=media_safe_prefix_min(tokens,
                                                    apc.media_token_ids),
            max_prefix_tokens=S - guard, min_capacity=capacity,
            device=model.device or "cpu")

        def store(c):
            apc.store_exact(tokens, c, extra, capacity=capacity)

        return cache, prefix_len, store
    if mode == "block":
        prefix_len, blocks = apc.lookup(tokens, extra)
        try:
            cache = apc.make_warm_cache(blocks, model, capacity, dtype)
        finally:
            apc.release(blocks)

        def commit(c):
            apc.commit(tokens, c, extra, upto=S)

        return cache, prefix_len, commit
    return None, 0, None


def stream_generate(
    model,
    processor,
    prompt: Union[str, List[int], np.ndarray],
    image: Optional[Any] = None,
    audio: Optional[Any] = None,
    video: Optional[Any] = None,
    *,
    max_tokens: int = 256,
    temperature: float = 0.0,
    top_p: float = 0.0,
    min_p: float = 0.0,
    top_k: int = -1,
    repetition_penalty: Optional[float] = None,
    repetition_context_size: int = 20,
    logit_bias: Optional[dict] = None,
    seed: Optional[int] = None,
    prefill_step_size: int = 512,
    block_size: int = 32,
    kv_bits: Optional[float] = None,
    kv_group_size: int = 64,
    apc=None,
    vision_cache=None,
    draft_model=None,
    num_draft_tokens: int = 4,
    fps=None,
    top_n_sigma: float = -1.0,
    typical_p: float = 0.0,
    xtc_probability: float = 0.0,
    xtc_threshold: float = 0.1,
    presence_penalty: Optional[float] = None,
    frequency_penalty: Optional[float] = None,
) -> Generator[GenerationResult, None, None]:
    """Stream GenerationResult chunks, one per generated token.

    `video` is one video or a list of them (utils/processing.py
    `prepare_inputs`): a path or frames (a uint8 [T, H, W, 3] array or a
    list of frames), `fps` a number or one per video (a path's sampling
    rate, or the rate of frames given).  The prompt holds a
    <|vision_start|><|video_pad|><|vision_end|> for each video
    (apply_chat_template(..., video=...) writes one); a model without a
    video token raises NotImplementedError.  `top_n_sigma`, `typical_p`,
    `xtc_probability` / `xtc_threshold` and the presence / frequency
    penalties are core/sampling.py's.

    `vision_cache` (vision_cache.VisionFeatureCache) keeps the vision
    tower's features by image content.  `apc` (apc.APCManager) reuses the
    longest cached prefix of the prompt in the mode `model_apc_mode` gives
    for `kv_bits`: "block" restores the prefix's K/V blocks into a warm
    cache and commits the prompt's blocks once it is prefilled; "exact"
    restores the longest stored snapshot that leaves at least
    APC_EXACT_PREFIX_GUARD_TOKENS (default 16) tokens to prefill and fits
    the continuation, and stores the prompt's snapshot.  The whole prompt
    is embedded first (the vision tower included, unless `vision_cache`
    holds its features), as in the reference.

    `draft_model` (a vanilla drafter of the target's vocabulary) decodes
    speculatively, `num_draft_tokens` drafted a round, with the same
    sampling arguments, as the reference's branch does (:223-241): that
    branch passes no `kv_bits`, no prompt cache, no logits processors and
    no `block_size`, so with a drafter both caches are bf16 and `apc`,
    `kv_bits`, `kv_group_size`, `block_size`, `logit_bias`,
    `repetition_penalty`, the presence / frequency penalties and the
    filters past top-k / top-p / min-p are ignored (no APC lookup is
    made)."""
    if audio is not None:
        raise NotImplementedError("audio is not ported")
    if video is not None and getattr(getattr(model, "config", None),
                                     "video_token_id", None) is None:
        raise NotImplementedError(
            f"{type(model).__module__} takes no video: its config has no "
            f"video token")
    if draft_model is not None:
        from ..speculative.utils import validate_drafter_compatibility

        validate_drafter_compatibility(model, draft_model)
        apc = kv_bits = None
    check_kv_bits(kv_bits)

    inputs = prepare_inputs(processor, prompt, images=image, videos=video,
                            fps=fps)
    input_ids = np.asarray(inputs["input_ids"])
    dev = model.device

    tic = time.perf_counter()
    embeds, position_ids, rope_deltas = embed_prompt(model, inputs,
                                                     vision_cache)
    prompt_cache, prefix_len, prompt_cache_callback = None, 0, None
    if apc is not None:
        prompt_cache, prefix_len, prompt_cache_callback = _apc_lookup(
            apc, model, inputs, embeds.dtype, max_tokens, block_size,
            kv_bits, kv_group_size)

    sampler = make_sampler(temperature, top_p, min_p, top_k, top_n_sigma,
                           typical_p, xtc_probability, xtc_threshold)
    processors = make_logits_processors(logit_bias, repetition_penalty,
                                        repetition_context_size,
                                        presence_penalty, frequency_penalty)
    eos_ids = _get_eos_ids(model, processor)
    detok = make_detokenizer(getattr(processor, "tokenizer", processor))

    prompt_tokens = int(input_ids.shape[1])
    prompt_time = None
    gen_start = None
    n = 0
    if draft_model is not None:
        from ..speculative import utils as spec

        token_iter = spec.speculative_generate_step(
            embeds, model, draft_model, input_ids=input_ids,
            position_ids=position_ids, rope_deltas=rope_deltas,
            max_tokens=max_tokens, num_draft=num_draft_tokens,
            prefill_step_size=prefill_step_size, temperature=temperature,
            top_p=top_p, min_p=min_p, top_k=top_k, seed=seed)
    else:
        token_iter = generate_step(
            embeds, model, position_ids=position_ids,
            rope_deltas=rope_deltas, max_tokens=max_tokens, sampler=sampler,
            logits_processors=processors,
            prefill_step_size=prefill_step_size, seed=seed,
            block_size=block_size, kv_bits=kv_bits,
            kv_group_size=kv_group_size, prompt_cache=prompt_cache,
            prefix_len=prefix_len,
            prompt_cache_callback=prompt_cache_callback)
    phases = global_phases()
    while True:
        # the first pull runs the prefill, the rest are decode steps: named
        # regions in a torch.profiler trace and host time at /metrics
        with annotate("prefill" if prompt_time is None else "decode",
                      phases):
            try:
                token, logprobs = next(token_iter)
            except StopIteration:
                break
        now = time.perf_counter()
        if prompt_time is None:
            prompt_time = now - tic
            gen_start = now
        t = int(np.asarray(token).reshape(-1)[0])
        n += 1
        common = dict(
            token=t, logprobs=logprobs, prompt_tokens=prompt_tokens,
            generation_tokens=n,
            prompt_tps=prompt_tokens / max(prompt_time, 1e-9),
            generation_tps=(n - 1) / max(now - gen_start, 1e-9) if n > 1 else 0.0,
            peak_memory=device_peak_memory_gb(dev))
        if t in eos_ids:
            yield GenerationResult(text="", finish_reason="stop", **common)
            return
        detok.add_token(t)
        is_last = n >= max_tokens
        text = detok.last_segment()
        if is_last:
            text += detok.finalize()
        yield GenerationResult(text=text,
                               finish_reason="length" if is_last else None,
                               **common)


def generate(model, processor, prompt: Union[str, List[int]],
             image: Optional[Any] = None, audio: Optional[Any] = None,
             video: Optional[Any] = None, verbose: bool = False,
             **kwargs) -> GenerationResult:
    """Blocking generate: the last GenerationResult with the whole text."""
    pieces: List[str] = []
    last: Optional[GenerationResult] = None
    for res in stream_generate(model, processor, prompt, image, audio, video,
                               **kwargs):
        pieces.append(res.text)
        last = res
        if verbose and res.text:
            print(res.text, end="", flush=True)
    if verbose:
        print()
        if last:
            print(f"Prompt: {last.prompt_tokens} tokens, "
                  f"{last.prompt_tps:.3f} tokens-per-sec")
            print(f"Generation: {last.generation_tokens} tokens, "
                  f"{last.generation_tps:.3f} tokens-per-sec")
            print(f"Peak memory: {last.peak_memory:.3f} GB")
    if last is None:
        return GenerationResult(
            text="", token=None, logprobs=None, prompt_tokens=0,
            generation_tokens=0, prompt_tps=0.0, generation_tps=0.0,
            peak_memory=0.0, finish_reason="length")
    last.text = "".join(pieces)
    return last
