"""Anthropic-compatible /v1/messages.

Port of mlx_vlm_tpu/server/anthropic.py (normalize_messages_request :33,
messages_endpoint :72, count_tokens :158), verbatim: system
normalization, image source conversion, SSE event stream, stop_reason
mapping, count_tokens.
"""

from __future__ import annotations

import base64
import io
import json
import time
import uuid
from typing import Any, List

from ..prompt_utils import apply_chat_template
from .engine import GenerationArguments

_STOP_MAP = {"stop": "end_turn", "length": "max_tokens"}


def _decode_source(src: dict):
    from PIL import Image

    if src.get("type") == "base64":
        return Image.open(io.BytesIO(base64.b64decode(src["data"])))
    if src.get("type") == "url":
        return src["url"]
    raise ValueError(f"unsupported image source {src.get('type')}")


def normalize_messages_request(body: dict, model, processor) -> GenerationArguments:
    from .schemas import AnthropicMessagesRequest

    req = AnthropicMessagesRequest(**body)
    images: List[Any] = []
    messages = []
    if req.system:
        sys_text = (
            req.system
            if isinstance(req.system, str)
            else "".join(b.get("text", "") for b in req.system)
        )
        messages.append({"role": "system", "content": sys_text})
    for m in req.messages:
        if isinstance(m.content, str):
            messages.append({"role": m.role, "content": m.content})
            continue
        parts = []
        for block in m.content:
            if block.type == "text":
                parts.append({"type": "text", "text": block.text or ""})
            elif block.type == "image":
                images.append(_decode_source(block.source or {}))
                parts.append({"type": "image"})
        messages.append({"role": m.role, "content": parts})
    prompt = apply_chat_template(
        processor, getattr(model, "config_dict", {}), messages,
        add_generation_prompt=True, num_images=len(images),
    )
    return GenerationArguments(
        prompt=prompt,
        images=images,
        max_tokens=req.max_tokens,
        temperature=req.temperature or 0.0,
        top_p=0.0 if (req.top_p or 1.0) >= 1.0 else req.top_p,
        stop=req.stop_sequences or [],
    )


def messages_endpoint(handler, body: dict, generator, model_name: str):
    args = normalize_messages_request(body, generator.model, generator.processor)
    mid = f"msg_{uuid.uuid4().hex[:24]}"
    stream = bool(body.get("stream", False))
    it = generator.generate(args)

    if stream:
        handler.start_sse()
        handler.send_sse_event("message_start", {
            "type": "message_start",
            "message": {
                "id": mid, "type": "message", "role": "assistant",
                "model": model_name, "content": [],
                "usage": {"input_tokens": 0, "output_tokens": 0},
            },
        })
        handler.send_sse_event("content_block_start", {
            "type": "content_block_start", "index": 0,
            "content_block": {"type": "text", "text": ""},
        })
        n_gen = 0
        stop_reason = "end_turn"
        for tok in it:
            if tok.error:
                handler.send_sse_event("error", {
                    "type": "error",
                    "error": {"type": "api_error", "message": tok.error},
                })
                break
            if tok.text:
                handler.send_sse_event("content_block_delta", {
                    "type": "content_block_delta", "index": 0,
                    "delta": {"type": "text_delta", "text": tok.text},
                })
            if tok.token is not None:
                n_gen += 1
            if tok.finish_reason:
                stop_reason = _STOP_MAP.get(tok.finish_reason, "end_turn")
                break
        handler.send_sse_event("content_block_stop",
                               {"type": "content_block_stop", "index": 0})
        handler.send_sse_event("message_delta", {
            "type": "message_delta",
            "delta": {"stop_reason": stop_reason, "stop_sequence": None},
            "usage": {"output_tokens": n_gen},
        })
        handler.send_sse_event("message_stop", {"type": "message_stop"})
        return None

    pieces = []
    n_gen = 0
    stop_reason = "end_turn"
    error = None
    for tok in it:
        if tok.error:
            error = tok.error
            break
        pieces.append(tok.text)
        if tok.token is not None:
            n_gen += 1
        if tok.finish_reason:
            stop_reason = _STOP_MAP.get(tok.finish_reason, "end_turn")
            break
    if error:
        handler.send_json(
            {"type": "error", "error": {"type": "api_error", "message": error}}, 500
        )
        return None
    env = generator.metrics.envelope(args.request_id)
    handler.send_json({
        "id": mid,
        "type": "message",
        "role": "assistant",
        "model": model_name,
        "content": [{"type": "text", "text": "".join(pieces)}],
        "stop_reason": stop_reason,
        "stop_sequence": None,
        "usage": {
            "input_tokens": env.get("prompt_tokens", 0),
            "output_tokens": n_gen,
        },
    })
    return None


def count_tokens(handler, body: dict, generator, model_name: str):
    args = normalize_messages_request(body, generator.model, generator.processor)
    tok = getattr(generator.processor, "tokenizer", generator.processor)
    ids = tok(args.prompt)["input_ids"]
    n = len(ids[0]) if ids and isinstance(ids[0], (list,)) else len(ids)
    handler.send_json({"input_tokens": int(n)})
