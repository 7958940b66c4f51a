"""Port parity: the HTTP server (server/app.py and its routes) against the
JAX package's, both serving the same tiny f32 checkpoint
(`build_tiny_checkpoint`; the port's model on the CPU), started alike
(2 slots, capacity 256, blocks of 2 steps).

The same bodies go to both servers: /health, /v1/models, /metrics, the
web page, chat completions (not streamed and streamed; a PNG data-URI
image; `stop`; `logprobs`; `tools` -> `tool_calls`; `response_format`
json_object and json_schema), /v1/messages (and its stream) with
count_tokens, /v1/responses with retrieve, delete, input_items and
`previous_response_id`, the image-generation, detection and audio routes
(400, no such model), and the error answers.  Requests sent one after
another give equal texts, finish reasons and usage; concurrent ones (more
than the slots, so that some wait) give equal texts, with logprobs within
1e-4, the tolerance of tests/test_torch_batch.py for the f32 cache.
"""

import base64
import io
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.server.app import create_server as jax_create_server
from mlx_vlm_tpu.utils.testing import build_tiny_checkpoint
from mlx_vlm_tpu_torch.server.app import create_server

torch.set_num_threads(2)

LOGPROB_TOL = 1e-4


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"jax": url, "port": url} over the same checkpoint, and each
    server's ResponseGenerator."""
    d = tmp_path_factory.mktemp("tiny_qwen2_vl")
    build_tiny_checkpoint(str(d))
    jm, jp = mlx_vlm_tpu.load(str(d), dtype=jnp.float32)
    tm, tp = mlx_vlm_tpu_torch.load(str(d), dtype=torch.float32,
                                      device="cpu")
    urls, httpds = {}, {}
    for name, make, model, proc in (("jax", jax_create_server, jm, jp),
                                    ("port", create_server, tm, tp)):
        port = _free_port()
        httpd = make(model, proc, model_name="tiny-qwen2-vl",
                     host="127.0.0.1", port=port, num_slots=2, capacity=256,
                     block_size=2, token_queue_timeout=120.0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        urls[name], httpds[name] = f"http://127.0.0.1:{port}", httpd
    yield urls, {k: h.state.generator for k, h in httpds.items()}
    for httpd in httpds.values():
        httpd.shutdown()
        httpd.state.generator.shutdown()


def _request(url, path, body=None, raw=None, headers=None, method=None):
    """(status, content type, body bytes) of one request; HTTP errors are
    returned, not raised."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        url + path, data=data, method=method or ("GET" if data is None
                                                 else "POST"),
        headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _both(servers, path, body=None, **kw):
    urls, _ = servers
    return [_request(urls[k], path, body, **kw) for k in ("jax", "port")]


def _json(resp):
    return resp[0], json.loads(resp[2])


def _sse(raw: bytes) -> list:
    """An SSE body as [(event name or None, data)]."""
    out, event = [], None
    for line in raw.decode().splitlines():
        if line.startswith("event: "):
            event = line[7:]
        elif line.startswith("data: "):
            payload = line[6:]
            out.append((event, payload if payload == "[DONE]"
                        else json.loads(payload)))
            event = None
    return out


def _png_b64(size: int = 56) -> str:
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (size, size, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _chat(text, **kw):
    return {"messages": [{"role": "user", "content": text}], **kw}


def _same_logprobs(ref, got):
    assert [t["token"] for t in got] == [t["token"] for t in ref]
    assert [t["bytes"] for t in got] == [t["bytes"] for t in ref]
    np.testing.assert_allclose([t["logprob"] for t in got],
                               [t["logprob"] for t in ref], rtol=0,
                               atol=LOGPROB_TOL)


def _same_completion(ref, got):
    assert got["object"] == ref["object"] == "chat.completion"
    assert got["model"] == ref["model"]
    assert got["usage"] == ref["usage"]
    rc, gc = ref["choices"][0], got["choices"][0]
    assert gc["finish_reason"] == rc["finish_reason"]
    assert gc["message"] == rc["message"]
    assert ("logprobs" in gc) == ("logprobs" in rc)
    if "logprobs" in rc:
        _same_logprobs(rc["logprobs"]["content"], gc["logprobs"]["content"])


@pytest.mark.parametrize("path", ["/health", "/v1/models", "/models",
                                  "/v1/cache/stats", "/nope",
                                  "/v1/responses/resp_missing"])
def test_get_routes_match_jax(servers, path):
    ref, got = _both(servers, path)
    assert got[0] == ref[0] and got[1] == ref[1]
    assert json.loads(got[2]) == json.loads(ref[2])


def test_web_page_matches_jax(servers):
    ref, got = _both(servers, "/")
    assert got == ref and got[1].startswith("text/html")


def test_metrics_match_jax(servers):
    (rs, ref), (gs, got) = map(_json, _both(servers, "/metrics"))
    assert rs == gs == 200
    assert got.keys() == ref.keys()
    assert isinstance(got["phases"], dict)
    assert got["requests_total"] >= 0 and got["uptime_s"] > 0


CHATS = {
    "text": _chat("Hello there friend", max_tokens=6),
    "system": {"messages": [{"role": "system", "content": "Be terse."},
                            {"role": "user", "content": "Hi"}],
               "max_completion_tokens": 5},
    "logprobs": _chat("logprobs please", max_tokens=5, logprobs=True),
    "image": {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "What is this?"},
        {"type": "image_url",
         "image_url": {"url": "data:image/png;base64," + _png_b64()}}]}],
        "max_tokens": 4, "logprobs": True},
    "long": _chat("Describe the picture please, thank you very much.",
                  max_tokens=12),
    "json_object": _chat("Emit some JSON", max_tokens=24,
                         response_format={"type": "json_object"}),
    "json_schema": _chat("Classify the animal", max_tokens=48,
                         response_format={"type": "json_schema",
                                          "json_schema": {"schema": {
                                              "type": "object",
                                              "properties": {"kind": {
                                                  "type": "string",
                                                  "enum": ["cat", "dog"]}},
                                              "required": ["kind"],
                                              "additionalProperties":
                                                  False}}}),
    "tools": _chat("What is the weather in Paris?", max_tokens=6, tools=[
        {"type": "function", "function": {"name": "get_weather"}}]),
}


@pytest.mark.parametrize("name", list(CHATS))
def test_chat_completion_matches_jax(servers, name):
    (rs, ref), (gs, got) = map(_json, _both(servers, "/v1/chat/completions",
                                            CHATS[name]))
    assert rs == gs == 200
    _same_completion(ref, got)
    if name.startswith("json"):
        json.loads(got["choices"][0]["message"]["content"])


def test_stop_matches_jax(servers):
    """A stop string taken from the middle of the unstopped answer (so that
    it straddles detokenizer segments): both answers end before it."""
    urls, _ = servers
    body = _chat("Describe the picture please, thank you very much.",
                 max_tokens=24)
    _, full = _json(_request(urls["jax"], "/v1/chat/completions", body))
    text = full["choices"][0]["message"]["content"]
    assert len(text) >= 6
    stop = text[2:5]
    (rs, ref), (gs, got) = map(_json, _both(
        servers, "/v1/chat/completions", dict(body, stop=[stop, "zzz"])))
    assert rs == gs == 200
    _same_completion(ref, got)
    assert got["choices"][0]["finish_reason"] == "stop"
    assert got["choices"][0]["message"]["content"] == text[:text.find(stop)]


def test_tool_calls_match_jax(servers, monkeypatch):
    """A Hermes tool call in the answer becomes `tool_calls` (the ids are
    random) and finish_reason "tool_calls", in both servers; the answer is
    scripted, as a random model writes none."""
    _, gens = servers
    pieces = ["I will call.", '<tool_call>\n{"name": "get_weather", ',
              '"arguments": {"city": "Paris"}}\n</tool_call>']
    for gen in gens.values():
        mod = __import__(type(gen).__module__, fromlist=["StreamingToken"])

        def scripted(args, mod=mod):
            toks = [mod.StreamingToken(token=i + 1, text=p)
                    for i, p in enumerate(pieces)]
            toks.append(mod.StreamingToken(token=None, text="",
                                           finish_reason="stop"))
            return iter(toks)

        monkeypatch.setattr(gen, "generate", scripted)
    (rs, ref), (gs, got) = map(_json, _both(
        servers, "/v1/chat/completions", CHATS["tools"]))
    assert rs == gs == 200
    rc, gc = ref["choices"][0], got["choices"][0]
    assert gc["finish_reason"] == rc["finish_reason"] == "tool_calls"
    for c in (rc, gc):
        for call in c["message"]["tool_calls"]:
            call.pop("id")
    assert gc["message"] == rc["message"]
    assert gc["message"]["tool_calls"][0]["function"]["name"] == \
        "get_weather"


@pytest.mark.parametrize("name", ["text", "logprobs", "json_object"])
def test_chat_stream_matches_jax(servers, name):
    body = dict(CHATS[name], stream=True)
    ref, got = [_sse(r[2]) for r in _both(servers, "/v1/chat/completions",
                                          body)]
    for events in (ref, got):
        assert events[-1] == (None, "[DONE]")
        assert events[0][1]["choices"][0]["delta"].get("role") == \
            "assistant"
    chunks = [[e for _, e in ev[:-1]] for ev in (ref, got)]
    text = ["".join(c["choices"][0]["delta"].get("content", "") for c in ch)
            for ch in chunks]
    assert text[1] == text[0]
    last = [ch[-1] for ch in chunks]
    assert last[1]["choices"][0]["finish_reason"] == \
        last[0]["choices"][0]["finish_reason"]
    assert last[1]["usage"] == last[0]["usage"]
    assert len(chunks[1]) == len(chunks[0])


MESSAGES = {
    "text": {"model": "x", "max_tokens": 5, "system": "You are terse.",
             "messages": [{"role": "user", "content": "Hi"}]},
    "image": {"max_tokens": 4, "messages": [{"role": "user", "content": [
        {"type": "image", "source": {"type": "base64",
                                     "media_type": "image/png",
                                     "data": _png_b64()}},
        {"type": "text", "text": "Describe"}]}]},
}


@pytest.mark.parametrize("name", list(MESSAGES))
def test_messages_match_jax(servers, name):
    (rs, ref), (gs, got) = map(_json, _both(servers, "/v1/messages",
                                            MESSAGES[name]))
    assert rs == gs == 200
    for r in (ref, got):
        r.pop("id")
    assert got == ref


def test_messages_stream_matches_jax(servers):
    body = dict(MESSAGES["text"], stream=True)
    ref, got = [_sse(r[2]) for r in _both(servers, "/v1/messages", body)]
    assert [e for e, _ in got] == [e for e, _ in ref]
    assert ref[0][0] == "message_start" and ref[-1][0] == "message_stop"
    for events in (ref, got):
        events[0][1]["message"].pop("id")
    assert got == ref


@pytest.mark.parametrize("body", [
    {"messages": [{"role": "user", "content": "count me"}], "max_tokens": 1},
    {"system": "s", "messages": [{"role": "user", "content": [
        {"type": "text", "text": "two blocks"},
        {"type": "text", "text": "here"}]}]},
])
def test_count_tokens_matches_jax(servers, body):
    (rs, ref), (gs, got) = map(_json, _both(
        servers, "/v1/messages/count_tokens", body))
    assert rs == gs == 200 and got == ref and got["input_tokens"] > 0


def _strip_response(r: dict) -> dict:
    r = json.loads(json.dumps(r))
    for k in ("id", "created_at", "previous_response_id"):
        r.pop(k, None)
    for o in r.get("output", []):
        o.pop("id", None)
    return r


def test_responses_lifecycle_matches_jax(servers):
    """Create, retrieve, input_items, a chained second turn, delete, and the
    404s after it, on both servers."""
    urls, _ = servers
    seen = {}
    for k in ("jax", "port"):
        url = urls[k]
        s1, first = _json(_request(url, "/v1/responses", {
            "input": "First turn", "max_output_tokens": 4,
            "instructions": "Be brief."}))
        s2, again = _json(_request(url, f"/v1/responses/{first['id']}"))
        s3, items = _json(_request(
            url, f"/v1/responses/{first['id']}/input_items"))
        s4, second = _json(_request(url, "/v1/responses", {
            "input": [{"role": "user", "content": [
                {"type": "input_text", "text": "Second turn"}]}],
            "previous_response_id": first["id"], "max_output_tokens": 4}))
        s5, deleted = _json(_request(url, f"/v1/responses/{first['id']}",
                                     method="DELETE"))
        s6, _ = _json(_request(url, f"/v1/responses/{first['id']}"))
        s7, _ = _json(_request(url, f"/v1/responses/{first['id']}",
                               method="DELETE"))
        assert again == first
        assert second["previous_response_id"] == first["id"]
        assert deleted == {"id": first["id"], "object": "response",
                           "deleted": True}
        seen[k] = ((s1, s2, s3, s4, s5, s6, s7), _strip_response(first),
                   items, _strip_response(second))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == (200, 200, 200, 200, 200, 404, 404)


def test_responses_stream_matches_jax(servers):
    ref, got = [_sse(r[2]) for r in _both(servers, "/v1/responses", {
        "input": "stream", "max_output_tokens": 4, "stream": True})]
    assert [e for e, _ in got] == [e for e, _ in ref]
    assert ref[0][0] == "response.created"
    assert ref[-1][0] == "response.completed"
    assert (_strip_response(got[-1][1]["response"])
            == _strip_response(ref[-1][1]["response"]))
    assert ([d.get("delta") for _, d in got[1:-1]]
            == [d.get("delta") for _, d in ref[1:-1]])


def test_concurrent_requests_match_jax(servers):
    """Five chats sent at once to each server (2 slots: three wait): each
    answer's text equal to the JAX server's, logprobs within 1e-4."""
    urls, _ = servers
    bodies = [_chat(f"request number {i}", max_tokens=4 + i, logprobs=True)
              for i in range(5)]
    answers = {}
    for k in ("jax", "port"):
        results = [None] * len(bodies)

        def hit(i, url=urls[k], results=results):
            results[i] = _json(_request(url, "/v1/chat/completions",
                                        bodies[i]))

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        answers[k] = results
    for ref, got in zip(answers["jax"], answers["port"]):
        assert ref[0] == got[0] == 200
        rc, gc = ref[1]["choices"][0], got[1]["choices"][0]
        assert gc["message"] == rc["message"]
        assert gc["finish_reason"] == rc["finish_reason"]
        assert (got[1]["usage"]["completion_tokens"]
                == ref[1]["usage"]["completion_tokens"])
        _same_logprobs(rc["logprobs"]["content"], gc["logprobs"]["content"])


MULTIPART = ("multipart/form-data; boundary=XyZ",
             b"--XyZ\r\nContent-Disposition: form-data; name=\"model\"\r\n"
             b"\r\nm\r\n--XyZ--\r\n")
ERRORS = {
    "bad_json": ("/v1/chat/completions", None, b"{not json", None),
    "no_messages": ("/v1/chat/completions", {"max_tokens": 3}, None, None),
    "bad_type": ("/v1/chat/completions",
                 _chat("x", max_tokens="many"), None, None),
    "bad_messages": ("/v1/messages", {"messages": [{"role": "user"}]}, None,
                     None),
    "too_long": ("/v1/chat/completions", _chat("word " * 600, max_tokens=4),
                 None, None),
    "images": ("/v1/images/generations", {"prompt": "a cat"}, None, None),
    "edits": ("/v1/images/edits", {"prompt": "a cat"}, None, None),
    "detection": ("/v1/detection", {"image": "x"}, None, None),
    "speech_no_input": ("/v1/audio/speech", {"model": "m"}, None, None),
    "speech": ("/v1/audio/speech", {"input": "hello"}, None, None),
    "transcribe_not_multipart": ("/v1/audio/transcriptions", None, b"{}",
                                 {"Content-Type": "application/json"}),
    "transcribe_no_file": ("/v1/audio/translations", None, MULTIPART[1],
                           {"Content-Type": MULTIPART[0]}),
    "cache_reset": ("/v1/cache/reset", {}, None, None),
    "post_404": ("/v1/nope", {}, None, None),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_error_answers_match_jax(servers, name):
    path, body, raw, headers = ERRORS[name]
    ref, got = _both(servers, path, body, raw=raw, headers=headers)
    assert got[0] == ref[0], (ref, got)
    assert got[1] == ref[1]
    r, g = json.loads(ref[2]), json.loads(got[2])
    if name in ("no_messages", "bad_type", "bad_messages"):
        # the validators word their messages differently
        assert got[0] == 400
        assert g["error"]["type"] == r["error"]["type"] == \
            "invalid_request_error"
    else:
        assert g == r
