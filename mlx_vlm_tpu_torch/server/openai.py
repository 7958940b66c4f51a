"""OpenAI-compatible chat completions.

Port of mlx_vlm_tpu/server/openai.py (normalize_chat_request :44 with the
Hermes tools suffix :30, chat_completion :98), verbatim: streaming SSE,
image parts (url / base64 data URIs, decoded with PIL), `logprobs`,
`tools` -> `tool_calls` (tool_parsers "hermes"), usage accounting.
"""

from __future__ import annotations

import base64
import io
import json
import time
import uuid
from typing import Any, Dict, List, Tuple

from ..prompt_utils import apply_chat_template
from .engine import GenerationArguments


def _decode_image(url: str):
    from PIL import Image

    if url.startswith("data:"):
        payload = url.split(",", 1)[1]
        return Image.open(io.BytesIO(base64.b64decode(payload)))
    return url  # http/file path — resolved by load_image later


def _tools_system_suffix(tools: List[dict]) -> str:
    """Hermes-style tool prompt (reference tool_choice shim openai.py:193)."""
    defs = "\n".join(
        json.dumps(t.get("function", t)) for t in tools
    )
    return (
        "\n\n# Tools\n\nYou may call one or more functions. "
        "Available tools (JSON schema):\n" + defs +
        "\n\nTo call a tool, reply with:\n"
        '<tool_call>\n{"name": <function-name>, "arguments": <args-json>}\n'
        "</tool_call>"
    )


def normalize_chat_request(body: dict, model, processor) -> GenerationArguments:
    from .schemas import OpenAIChatRequest

    req = OpenAIChatRequest(**body)
    images: List[Any] = []
    messages = []
    tools = body.get("tools")
    if tools:
        sys_suffix = _tools_system_suffix(tools)
        msgs = [m.model_dump() for m in req.messages]
        if msgs and msgs[0]["role"] == "system" and isinstance(msgs[0]["content"], str):
            msgs[0]["content"] += sys_suffix
        else:
            msgs.insert(0, {"role": "system", "content": "You are a helpful assistant." + sys_suffix})
        from .schemas import OpenAIMessage

        req.messages = [OpenAIMessage(**m) for m in msgs]
    for m in req.messages:
        content = m.content
        if isinstance(content, list):
            text_parts = []
            parts = []
            for part in content:
                ptype = part.get("type")
                if ptype in ("image_url", "input_image", "image"):
                    url = part.get("image_url")
                    if isinstance(url, dict):
                        url = url.get("url")
                    url = url or part.get("url") or part.get("image")
                    images.append(_decode_image(url))
                    parts.append({"type": "image"})
                elif ptype in ("text", "input_text"):
                    text_parts.append(part.get("text", ""))
                    parts.append({"type": "text", "text": part.get("text", "")})
            messages.append({"role": m.role, "content": parts})
        else:
            messages.append({"role": m.role, "content": content or ""})
    prompt = apply_chat_template(
        processor, getattr(model, "config_dict", {}), messages,
        add_generation_prompt=True, num_images=len(images),
    )
    stop = req.stop if isinstance(req.stop, list) else ([req.stop] if req.stop else [])
    return GenerationArguments(
        prompt=prompt,
        images=images,
        max_tokens=req.max_tokens or req.max_completion_tokens or 512,
        temperature=req.temperature or 0.0,
        top_p=0.0 if (req.top_p or 1.0) >= 1.0 else req.top_p,
        stop=stop,
        seed=req.seed,
        response_format=req.response_format,
    )


def chat_completion(handler, body: dict, generator, model_name: str):
    """Handle POST /v1/chat/completions (stream + non-stream)."""
    args = normalize_chat_request(body, generator.model, generator.processor)
    created = int(time.time())
    cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
    stream = bool(body.get("stream", False))
    it = generator.generate(args)

    if stream:
        handler.start_sse()
        sent_role = False
        finish = "stop"
        n_gen = 0
        for tok in it:
            if tok.error:
                handler.send_sse({"error": {"message": tok.error}})
                break
            delta = {}
            if not sent_role:
                delta["role"] = "assistant"
                sent_role = True
            if tok.text:
                delta["content"] = tok.text
            if tok.token is not None:
                n_gen += 1
            chunk = {
                "id": cid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": model_name,
                "choices": [{
                    "index": 0,
                    "delta": delta,
                    "finish_reason": tok.finish_reason,
                }],
            }
            if tok.finish_reason:
                env = generator.metrics.envelope(args.request_id)
                chunk["usage"] = {
                    "prompt_tokens": env.get("prompt_tokens", 0),
                    "completion_tokens": n_gen,
                    "total_tokens": env.get("prompt_tokens", 0) + n_gen,
                }
                if env.get("generation_tps"):
                    chunk["timings"] = {
                        "predicted_per_second": env["generation_tps"]
                    }
            handler.send_sse(chunk)
            if tok.finish_reason:
                break
        handler.send_sse_done()
        return None

    pieces = []
    finish = "stop"
    n_gen = 0
    error = None
    token_logprobs = []
    for tok in it:
        if tok.error:
            error = tok.error
            break
        pieces.append(tok.text)
        if tok.token is not None:
            n_gen += 1
            if body.get("logprobs"):
                token_logprobs.append(
                    {"token": tok.text, "logprob": tok.logprob,
                     "bytes": list(tok.text.encode()) if tok.text else None}
                )
        if tok.finish_reason:
            finish = tok.finish_reason
            break
    if error:
        handler.send_json({"error": {"message": error, "type": "server_error"}}, 500)
        return None
    text = "".join(pieces)
    message = {"role": "assistant", "content": text}
    if body.get("tools"):
        from ..tool_parsers import get_tool_parser

        clean, calls = get_tool_parser("hermes").parse(text)
        if calls:
            message = {
                "role": "assistant",
                "content": clean or None,
                "tool_calls": [
                    {
                        "id": f"call_{uuid.uuid4().hex[:12]}",
                        "type": "function",
                        "function": {
                            "name": c["name"],
                            "arguments": json.dumps(c["arguments"]),
                        },
                    }
                    for c in calls
                ],
            }
            finish = "tool_calls"
    env = generator.metrics.envelope(args.request_id)
    choice = {"index": 0, "message": message, "finish_reason": finish}
    if body.get("logprobs"):
        choice["logprobs"] = {"content": token_logprobs}
    handler.send_json({
        "id": cid,
        "object": "chat.completion",
        "created": created,
        "model": model_name,
        "choices": [choice],
        "usage": {
            "prompt_tokens": env.get("prompt_tokens", 0),
            "completion_tokens": n_gen,
            "total_tokens": env.get("prompt_tokens", 0) + n_gen,
        },
    })
    return None
