"""OpenAI Responses API (/v1/responses).

Port of mlx_vlm_tpu/server/responses.py (create_response :74,
retrieve_response :152, delete_response :160, list_input_items :167),
verbatim: create (stream & non-stream), retrieve, delete, input_items,
previous_response_id chaining.
"""

from __future__ import annotations

import json
import time
from typing import Any, List

from ..prompt_utils import apply_chat_template
from .engine import GenerationArguments
from .openai import _decode_image
from .responses_state import ResponsesStateStore

STORE = ResponsesStateStore()


def _normalize_input(body: dict) -> List[dict]:
    """`input` may be a string or a list of message items."""
    inp = body.get("input", "")
    if isinstance(inp, str):
        return [{"role": "user", "content": inp}]
    items = []
    for item in inp:
        if item.get("type") in (None, "message"):
            items.append({"role": item.get("role", "user"),
                          "content": item.get("content", "")})
    return items


def _to_generation_args(body: dict, model, processor, store: ResponsesStateStore):
    messages = []
    if body.get("previous_response_id"):
        messages.extend(store.conversation_chain(body["previous_response_id"]))
    if body.get("instructions"):
        messages.insert(0, {"role": "system", "content": body["instructions"]})
    input_items = _normalize_input(body)
    images: List[Any] = []
    for m in input_items:
        content = m["content"]
        if isinstance(content, list):
            parts = []
            for part in content:
                t = part.get("type")
                if t in ("input_text", "text"):
                    parts.append({"type": "text", "text": part.get("text", "")})
                elif t in ("input_image", "image_url"):
                    url = part.get("image_url") or part.get("url")
                    if isinstance(url, dict):
                        url = url.get("url")
                    images.append(_decode_image(url))
                    parts.append({"type": "image"})
            messages.append({"role": m["role"], "content": parts})
        else:
            messages.append(m)
    prompt = apply_chat_template(
        processor, getattr(model, "config_dict", {}), messages,
        add_generation_prompt=True, num_images=len(images),
    )
    args = GenerationArguments(
        prompt=prompt,
        images=images,
        max_tokens=body.get("max_output_tokens") or 512,
        temperature=body.get("temperature") or 0.0,
        top_p=0.0 if (body.get("top_p") or 1.0) >= 1.0 else body["top_p"],
    )
    return args, input_items


def create_response(handler, body: dict, generator, model_name: str):
    args, input_items = _to_generation_args(
        body, generator.model, generator.processor, STORE
    )
    rid = STORE.new_id()
    created = int(time.time())
    stream = bool(body.get("stream", False))
    it = generator.generate(args)

    def final_response(text: str, n_gen: int, status="completed") -> dict:
        env = generator.metrics.envelope(args.request_id)
        return {
            "id": rid,
            "object": "response",
            "created_at": created,
            "status": status,
            "model": model_name,
            "previous_response_id": body.get("previous_response_id"),
            "output": [{
                "type": "message",
                "id": f"msg_{rid[5:]}",
                "role": "assistant",
                "content": [{"type": "output_text", "text": text,
                             "annotations": []}],
            }],
            "usage": {
                "input_tokens": env.get("prompt_tokens", 0),
                "output_tokens": n_gen,
                "total_tokens": env.get("prompt_tokens", 0) + n_gen,
            },
        }

    if stream:
        handler.start_sse()
        handler.send_sse_event("response.created", {
            "type": "response.created",
            "response": {"id": rid, "object": "response", "status": "in_progress"},
        })
        pieces = []
        n_gen = 0
        for tok in it:
            if tok.error:
                handler.send_sse_event("error", {"type": "error",
                                                 "message": tok.error})
                break
            if tok.text:
                pieces.append(tok.text)
                handler.send_sse_event("response.output_text.delta", {
                    "type": "response.output_text.delta",
                    "delta": tok.text,
                })
            if tok.token is not None:
                n_gen += 1
            if tok.finish_reason:
                break
        resp = final_response("".join(pieces), n_gen)
        STORE.put(resp, input_items)
        handler.send_sse_event("response.completed", {
            "type": "response.completed", "response": resp,
        })
        return

    pieces = []
    n_gen = 0
    for tok in it:
        if tok.error:
            handler.send_json({"error": {"message": tok.error}}, 500)
            return
        pieces.append(tok.text)
        if tok.token is not None:
            n_gen += 1
        if tok.finish_reason:
            break
    resp = final_response("".join(pieces), n_gen)
    STORE.put(resp, input_items)
    handler.send_json(resp)


def retrieve_response(handler, rid: str):
    resp = STORE.get(rid)
    if resp is None:
        handler.send_json({"error": {"message": f"response {rid} not found"}}, 404)
    else:
        handler.send_json(resp)


def delete_response(handler, rid: str):
    if STORE.delete(rid):
        handler.send_json({"id": rid, "object": "response", "deleted": True})
    else:
        handler.send_json({"error": {"message": f"response {rid} not found"}}, 404)


def list_input_items(handler, rid: str):
    items = STORE.input_items(rid)
    if items is None:
        handler.send_json({"error": {"message": f"response {rid} not found"}}, 404)
    else:
        handler.send_json({
            "object": "list",
            "data": [
                {"type": "message", "id": f"item_{i}", **m}
                for i, m in enumerate(items)
            ],
        })
