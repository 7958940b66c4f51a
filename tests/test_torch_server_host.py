"""Port parity: the server's host code (server/schemas.py, the request
normalizations, the engine's scheduling loop, the metrics store,
utils/profiling.py, vision_cache.py, the CLI), and what the port refuses.

- `normalize_chat_request`, `normalize_messages_request` and the Responses
  normalization give GenerationArguments equal field by field to the JAX
  package's (request ids aside; images compared as pixels);
- the schema validator against the reference's pydantic models: the same
  bodies, valid and invalid, give the same acceptance and the same
  `model_dump()`;
- the engine's loop (`ResponseGenerator._run`) on a scripted batch and
  detokenizer, the same in both packages: the host-side stop-sequence scan
  across segment boundaries, EOS, length exhaustion, cancellation and the
  metrics envelope;
- image and detection models and extra models for the hot-swap registry
  raise NotImplementedError; a draft model of another vocabulary raises
  ValueError, and `serve` / the CLI pass `--draft-model` on to the load;
- importing `mlx_vlm_tpu_torch.server.app` (and apc.py, apc_adapters.py,
  the chat and generate commands) pulls in no jax, no mlx_vlm_tpu and no
  pydantic.
"""

import base64
import dataclasses
import io
import json
import os
import queue
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest

from mlx_vlm_tpu import vision_cache as jvc
from mlx_vlm_tpu.server import anthropic as janth
from mlx_vlm_tpu.server import engine as jeng
from mlx_vlm_tpu.server import openai as joai
from mlx_vlm_tpu.server import responses as jresp
from mlx_vlm_tpu.server import schemas as jschemas
from mlx_vlm_tpu.server.responses_state import ResponsesStateStore as JStore
from mlx_vlm_tpu.utils.processing import load_processor as jload_processor
from mlx_vlm_tpu.utils.testing import build_tiny_checkpoint
from mlx_vlm_tpu_torch import vision_cache as tvc
from mlx_vlm_tpu_torch.server import anthropic as tanth
from mlx_vlm_tpu_torch.server import engine as teng
from mlx_vlm_tpu_torch.server import openai as toai
from mlx_vlm_tpu_torch.server import responses as tresp
from mlx_vlm_tpu_torch.server import schemas as tschemas
from mlx_vlm_tpu_torch.server.responses_state import \
    ResponsesStateStore as TStore
from mlx_vlm_tpu_torch.utils import profiling as tprof
from mlx_vlm_tpu_torch.utils.processing import \
    load_processor as tload_processor

REPO = Path(__file__).resolve().parent.parent


def _png_data_uri(seed: int = 0, size: int = 56) -> str:
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """(model stand-in with the tiny checkpoint's config, JAX processor,
    port processor)."""
    d = tmp_path_factory.mktemp("tiny_qwen2_vl")
    cfg = build_tiny_checkpoint(str(d))
    model = types.SimpleNamespace(config_dict=cfg)
    return model, jload_processor(str(d)), tload_processor(str(d))


def _fields(args) -> dict:
    out = dataclasses.asdict(args)
    out.pop("request_id")
    out["images"] = [np.asarray(im) if not isinstance(im, str) else im
                     for im in args.images]
    return out


def _assert_same_args(ref, got):
    assert type(got).__name__ == type(ref).__name__ == "GenerationArguments"
    r, g = _fields(ref), _fields(got)
    assert r.keys() == g.keys()
    for k in r:
        if k == "images":
            assert len(g[k]) == len(r[k])
            for a, b in zip(g[k], r[k]):
                assert np.array_equal(np.asarray(a), np.asarray(b))
        else:
            assert g[k] == r[k], k
            assert type(g[k]) is type(r[k]), k


IMG = _png_data_uri()
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}}}}}]
CHAT_BODIES = [
    {"messages": [{"role": "user", "content": "Hello there"}]},
    {"messages": [{"role": "system", "content": "Be terse."},
                  {"role": "user", "content": "Hi"},
                  {"role": "assistant", "content": "Hello."},
                  {"role": "user", "content": "Again"}],
     "max_tokens": 7, "temperature": 0.7, "top_p": 0.9, "seed": 3},
    {"messages": [{"role": "user", "content": "Weather?"}], "tools": TOOLS},
    {"messages": [{"role": "system", "content": "Sys."},
                  {"role": "user", "content": "Weather?"}], "tools": TOOLS},
    {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "What is this?"},
        {"type": "image_url", "image_url": {"url": IMG}}]}]},
    {"messages": [{"role": "user", "content": [
        {"type": "input_image", "image": IMG},
        {"type": "input_text", "text": "Describe"}]}], "max_tokens": 3},
    {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": "https://example.com/x.png"},
        {"type": "text", "text": "and?"}]}]},
    {"messages": [{"role": "user", "content": "s"}], "stop": "END"},
    {"messages": [{"role": "user", "content": "s"}], "stop": ["a", "bc"],
     "max_completion_tokens": 9},
    {"messages": [{"role": "user", "content": None}], "top_p": 1.0},
    {"messages": [{"role": "user", "content": "j"}],
     "response_format": {"type": "json_object"}, "logprobs": True},
    {"messages": [{"role": "user", "content": "t"}], "temperature": "0.5",
     "max_tokens": "12", "stream": "true", "extra_key": {"k": 1}},
]


@pytest.mark.parametrize("i", range(len(CHAT_BODIES)))
def test_normalize_chat_request_matches_jax(procs, i):
    model, jp, tp = procs
    body = json.loads(json.dumps(CHAT_BODIES[i]))
    ref = joai.normalize_chat_request(json.loads(json.dumps(body)), model, jp)
    got = toai.normalize_chat_request(body, model, tp)
    _assert_same_args(ref, got)


MESSAGES_BODIES = [
    {"messages": [{"role": "user", "content": "Hi"}]},
    {"system": "You are terse.", "max_tokens": 5,
     "messages": [{"role": "user", "content": "Hi"}],
     "stop_sequences": ["x"], "temperature": 0.3, "top_p": 0.5},
    {"system": [{"type": "text", "text": "A"}, {"type": "text", "text": "B"}],
     "messages": [{"role": "user", "content": [
         {"type": "image", "source": {"type": "base64",
                                      "media_type": "image/png",
                                      "data": IMG.split(",", 1)[1]}},
         {"type": "text", "text": "Describe"}]}]},
    {"messages": [{"role": "user", "content": [
        {"type": "image", "source": {"type": "url",
                                     "url": "https://example.com/a.png"}},
        {"type": "text"}]},
        {"role": "assistant", "content": "ok"},
        {"role": "user", "content": "more"}]},
]


@pytest.mark.parametrize("i", range(len(MESSAGES_BODIES)))
def test_normalize_messages_request_matches_jax(procs, i):
    model, jp, tp = procs
    body = MESSAGES_BODIES[i]
    ref = janth.normalize_messages_request(json.loads(json.dumps(body)),
                                           model, jp)
    got = tanth.normalize_messages_request(json.loads(json.dumps(body)),
                                           model, tp)
    _assert_same_args(ref, got)


def test_bad_image_source_raises_in_both(procs):
    model, jp, tp = procs
    body = {"messages": [{"role": "user", "content": [
        {"type": "image", "source": {"type": "file", "path": "x"}}]}]}
    for mod, p in ((janth, jp), (tanth, tp)):
        with pytest.raises(ValueError, match="unsupported image source"):
            mod.normalize_messages_request(body, model, p)


PREVIOUS = {"id": "resp_prev", "object": "response", "output": [
    {"type": "message", "content": [{"type": "output_text",
                                     "text": "Earlier answer"}]}],
    "previous_response_id": None}
RESPONSES_BODIES = [
    {"input": "Say something", "max_output_tokens": 5},
    {"input": [{"role": "user", "content": "First"},
               {"type": "reasoning", "content": "skipped"}],
     "instructions": "Be brief.", "temperature": 0.2, "top_p": 0.8},
    {"input": [{"type": "message", "role": "user", "content": [
        {"type": "input_text", "text": "Look"},
        {"type": "input_image", "image_url": IMG}]}]},
    {"input": "Second turn", "previous_response_id": "resp_prev",
     "instructions": "Sys."},
    {"input": [{"role": "user", "content": [
        {"type": "image_url", "url": {"url": IMG}}]}], "top_p": 1.0},
]


@pytest.mark.parametrize("i", range(len(RESPONSES_BODIES)))
def test_responses_normalization_matches_jax(procs, i):
    model, jp, tp = procs
    body = RESPONSES_BODIES[i]
    stores = []
    for Store in (JStore, TStore):
        store = Store()
        store.put(dict(PREVIOUS), [{"role": "user", "content": "First q"}])
        stores.append(store)
    ref, ref_items = jresp._to_generation_args(
        json.loads(json.dumps(body)), model, jp, stores[0])
    got, got_items = tresp._to_generation_args(
        json.loads(json.dumps(body)), model, tp, stores[1])
    _assert_same_args(ref, got)
    assert got_items == ref_items


def test_responses_state_store_matches_jax():
    stores = [JStore(max_entries=3), TStore(max_entries=3)]
    for s in stores:
        prev = None
        for k in range(5):
            resp = {"id": f"resp_{k}", "previous_response_id": prev,
                    "output": [{"content": [{"text": f"a{k}"}]}]}
            s.put(resp, [{"role": "user", "content": f"q{k}"}])
            prev = resp["id"]
    j, t = stores
    for rid in (f"resp_{k}" for k in range(5)):
        assert t.get(rid) == j.get(rid)
        assert t.input_items(rid) == j.input_items(rid)
        assert t.conversation_chain(rid) == j.conversation_chain(rid)
    assert t.delete("resp_4") == j.delete("resp_4") is True
    assert t.delete("resp_0") == j.delete("resp_0") is False


# ------------------------------------------------------------ schemas
MSG = {"role": "user", "content": "hi"}
SCHEMA_BODIES = [
    ("OpenAIChatRequest", {"messages": [MSG]}),
    ("OpenAIChatRequest", {}),
    ("OpenAIChatRequest", {"messages": []}),
    ("OpenAIChatRequest", {"messages": MSG}),
    ("OpenAIChatRequest", {"messages": ["hi"]}),
    ("OpenAIChatRequest", {"messages": [{"content": "x"}]}),
    ("OpenAIChatRequest", {"messages": [{"role": 1}]}),
    ("OpenAIChatRequest", {"messages": [{"role": "user", "content": 5}]}),
    ("OpenAIChatRequest", {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "a"}], "name": "bob"}]}),
    ("OpenAIChatRequest", {"messages": [{"role": "user", "content": [
        "not a dict"]}]}),
    ("OpenAIChatRequest", {"messages": [MSG], "model": "m",
                           "max_tokens": 5, "temperature": 1,
                           "top_p": 0.5, "stream": True, "seed": 7,
                           "logprobs": False}),
    ("OpenAIChatRequest", {"messages": [MSG], "max_tokens": "5",
                           "temperature": "0.25", "stream": "yes",
                           "logprobs": 1, "seed": 3.0}),
    ("OpenAIChatRequest", {"messages": [MSG], "max_tokens": 5.5}),
    ("OpenAIChatRequest", {"messages": [MSG], "max_tokens": "five"}),
    ("OpenAIChatRequest", {"messages": [MSG], "max_tokens": True}),
    ("OpenAIChatRequest", {"messages": [MSG], "temperature": None}),
    ("OpenAIChatRequest", {"messages": [MSG], "temperature": "hot"}),
    ("OpenAIChatRequest", {"messages": [MSG], "temperature": True}),
    ("OpenAIChatRequest", {"messages": [MSG], "stream": "maybe"}),
    ("OpenAIChatRequest", {"messages": [MSG], "stream": 2}),
    ("OpenAIChatRequest", {"messages": [MSG], "stream": None}),
    ("OpenAIChatRequest", {"messages": [MSG], "stop": "x"}),
    ("OpenAIChatRequest", {"messages": [MSG], "stop": ["x", "y"]}),
    ("OpenAIChatRequest", {"messages": [MSG], "stop": [1]}),
    ("OpenAIChatRequest", {"messages": [MSG], "stop": 3}),
    ("OpenAIChatRequest", {"messages": [MSG], "model": 3}),
    ("OpenAIChatRequest", {"messages": [MSG], "response_format": {
        "type": "json_schema", "json_schema": {"schema": {}}}}),
    ("OpenAIChatRequest", {"messages": [MSG], "response_format": "json"}),
    ("OpenAIChatRequest", {"messages": [MSG], "tools": [{"a": 1}],
                           "tool_choice": "auto", "n": 1}),
    ("OpenAIChatRequest", {"messages": [MSG], "seed": "1_000",
                           "max_completion_tokens": "+7"}),
    ("OpenAIMessage", {"role": "assistant"}),
    ("OpenAIMessage", {"role": "tool", "content": None,
                       "tool_call_id": "c1"}),
    ("AnthropicMessagesRequest", {"messages": [MSG]}),
    ("AnthropicMessagesRequest", {"messages": [{"role": "user"}]}),
    ("AnthropicMessagesRequest", {"messages": [{"role": "user",
                                                "content": None}]}),
    ("AnthropicMessagesRequest", {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "a"},
        {"type": "image", "source": {"type": "base64", "data": "xx"}}]}]}),
    ("AnthropicMessagesRequest", {"messages": [{"role": "user", "content": [
        {"text": "a"}]}]}),
    ("AnthropicMessagesRequest", {"messages": [{"role": "user", "content": [
        {"type": "text", "text": 5}]}]}),
    ("AnthropicMessagesRequest", {"messages": [MSG], "system": "s",
                                  "max_tokens": 9, "temperature": 0.1,
                                  "top_p": 0.2, "stream": False,
                                  "stop_sequences": ["q"],
                                  "metadata": {"u": 1}}),
    ("AnthropicMessagesRequest", {"messages": [MSG], "system": [
        {"type": "text", "text": "s"}]}),
    ("AnthropicMessagesRequest", {"messages": [MSG], "system": 3}),
    ("AnthropicMessagesRequest", {"messages": [MSG], "max_tokens": None}),
    ("AnthropicMessagesRequest", {"messages": [MSG],
                                  "stop_sequences": "q"}),
    ("AnthropicContentBlock", {"type": "text", "text": "x", "cache": 1}),
    ("AnthropicContentBlock", {"text": "x"}),
]


@pytest.mark.parametrize("i", range(len(SCHEMA_BODIES)))
def test_schema_validator_matches_pydantic(i):
    from pydantic import ValidationError as PydanticError

    name, body = SCHEMA_BODIES[i]
    ref_err = got_err = None
    try:
        ref = getattr(jschemas, name)(**json.loads(json.dumps(body)))
    except PydanticError as e:
        ref_err = e
    try:
        got = getattr(tschemas, name)(**json.loads(json.dumps(body)))
    except tschemas.ValidationError as e:
        got_err = e
    assert (got_err is None) == (ref_err is None), (ref_err, got_err)
    if ref_err is not None:
        assert isinstance(got_err, ValueError)
        # the same top-level fields fail
        assert ({loc[0] for loc, _ in got_err.errors}
                == {e["loc"][0] for e in ref_err.errors()})
        return
    assert got.model_dump() == ref.model_dump()
    for field, value in ref.model_dump().items():
        assert type(got.model_dump()[field]) is type(value), field
    for key in body:
        if key not in type(ref).model_fields:
            assert getattr(got, key) == getattr(ref, key)


def test_schema_nested_models_and_assignment():
    req = tschemas.OpenAIChatRequest(messages=[MSG, {"role": "a",
                                                     "content": "b"}])
    assert isinstance(req.messages[0], tschemas.OpenAIMessage)
    assert req.messages[1].role == "a"
    req.messages = [tschemas.OpenAIMessage(**m.model_dump())
                    for m in req.messages[:1]]
    assert req.model_dump()["messages"] == [MSG]
    with pytest.raises(AttributeError):
        req.not_a_field
    with pytest.raises(TypeError):
        tschemas.OpenAIChatRequest(**[MSG])  # not a mapping: no 400


# ------------------------------------------------------------ engine loop
class _Req:
    def __init__(self, uid):
        self.uid = uid


class _ScriptedBatch:
    """Stands in for BatchGenerator: each `next()` hands every admitted
    request its next chunk of scripted (token, logprob) pairs; a request
    whose script is used up leaves its slot (length exhausted)."""

    def __init__(self, chunks):
        self.chunks = chunks
        self.slots, self.queue = [], []
        self.removed = []

    @property
    def num_active(self):
        return len(self.slots)

    def insert(self, req):
        self.slots.append(types.SimpleNamespace(req=req, left=list(
            self.chunks)))

    def remove(self, uid):
        self.removed.append(uid)
        self.slots = [s for s in self.slots if s.req.uid != uid]

    def next(self):
        out = {}
        for s in list(self.slots):
            out[s.req.uid] = s.left.pop(0)
            if not s.left:
                self.slots.remove(s)
        return out


class _ScriptedDetok:
    """Token t's segment is SEGMENTS[t]; finalize returns "<fin>"."""

    SEGMENTS = {1: "Hel", 2: "lo ", 3: "wor", 4: "ld!", 5: " S", 6: "TO",
                7: "P here", 8: "x", 9: ""}

    def __init__(self):
        self.seg = ""

    def add_token(self, t):
        self.seg = self.SEGMENTS[t]

    def last_segment(self):
        return self.seg

    def finalize(self):
        return "<fin>"


def _scripted_engine(mod, chunks, eos=(0,)):
    """`mod`'s ResponseGenerator without a model: its loop over a
    _ScriptedBatch, its `_prepare` replaced by the bookkeeping the real one
    does after the device work."""
    eng = mod.ResponseGenerator.__new__(mod.ResponseGenerator)
    eng.batch = _ScriptedBatch(chunks)
    eng.eos_ids = tuple(eos)
    eng.apc = None
    eng.metrics = mod.ServerMetricsStore()
    eng.token_queue_timeout = 30.0
    eng._requests = queue.Queue()
    eng._cancel = set()
    eng._cancel_lock = threading.Lock()
    eng._queues = {}
    eng._meta = {}
    eng._stop = threading.Event()

    def prepare(args):
        eng._meta[args.request_id] = {
            "prompt_tokens": 11, "t_submit": 0.0, "t_first": None,
            "generated": 0, "detok": _ScriptedDetok(), "stop": args.stop,
            "tail": ""}
        return _Req(args.request_id)

    eng._prepare = prepare
    eng._thread = threading.Thread(target=eng._run, daemon=True)
    eng._thread.start()
    return eng


SCRIPTS = [
    # (chunks of (token, logprob) per next(), stop strings)
    ([[(1, -0.1), (2, -0.2)], [(3, -0.3), (4, -0.4)]], []),
    ([[(1, -0.1), (2, -0.2)], [(3, -0.3), (4, -0.4)]], ["lo w"]),
    ([[(1, -0.1)], [(2, -0.2)], [(3, -0.3)], [(4, -0.4)]], ["low"]),
    ([[(1, -0.1)], [(2, -0.2)], [(3, -0.3)], [(4, -0.4)]], ["o wor"]),
    ([[(5, -0.1), (6, -0.2)], [(7, -0.3), (8, -0.4)]], ["STOP", "Hel"]),
    ([[(5, -0.1)], [(6, -0.2)], [(7, -0.3)]], ["TOP h"]),
    ([[(1, -0.1), (0, -0.5)], [(3, -0.3)]], []),
    ([[(1, -0.1), (9, -0.2)], [(2, -0.3)]], ["lo"]),
    ([[(1, -0.1), (2, -0.2)], [(3, -0.3)]], ["zzz", "ld"]),
]


@pytest.mark.parametrize("i", range(len(SCRIPTS)))
def test_engine_loop_matches_jax(i):
    """The same scripted stream through both packages' `_run`: the same
    StreamingTokens (stop-sequence trims across segment boundaries, EOS,
    length exhaustion with the detokenizer's tail) and the same metrics
    envelope."""
    chunks, stop = SCRIPTS[i]
    outs, envs = [], []
    for mod in (jeng, teng):
        eng = _scripted_engine(mod, chunks)
        try:
            args = mod.GenerationArguments(prompt="p", stop=list(stop),
                                           request_id=f"r{i}")
            toks = list(eng.generate(args))
            for _ in range(200):
                if eng.metrics.snapshot()["requests_total"]:
                    break
                threading.Event().wait(0.01)
        finally:
            eng.shutdown()
        outs.append([(t.token, t.text, t.logprob, t.finish_reason, t.error)
                     for t in toks])
        env = eng.metrics.snapshot()["recent"][-1]
        envs.append((sorted(env), env["request_id"], env["prompt_tokens"],
                     env["generation_tokens"]))
        outs[-1].append(eng.batch.removed)
    assert outs[1] == outs[0]
    assert envs[1] == envs[0]


def test_engine_cancellation_matches_jax():
    """A request cancelled before the owner thread takes it is never
    admitted, in both packages."""
    for mod in (jeng, teng):
        eng = _scripted_engine(mod, [[(1, -0.1)]])
        try:
            eng._stop.set()
            eng._thread.join(timeout=10)
            args = mod.GenerationArguments(prompt="p", request_id="c")
            eng.cancel("c")
            it = eng.generate(args)
            eng._stop.clear()
            eng._thread = threading.Thread(target=eng._run, daemon=True)
            eng._thread.start()
            for _ in range(100):
                if eng._requests.empty():
                    break
                threading.Event().wait(0.01)
            threading.Event().wait(0.1)
            assert eng.batch.slots == [] and "c" not in eng._meta
            assert eng._cancel == set()
        finally:
            eng.shutdown()
        del it


def test_metrics_store_matches_jax():
    envs = [{"request_id": f"r{k}", "prompt_tokens": k, "generation_tokens":
             2 * k, "ttft_s": 0.1 * k, "generation_tps": 3.0 * k}
            for k in range(30)]
    snaps = []
    for mod in (jeng, teng):
        store = mod.ServerMetricsStore(history=25)
        for e in envs:
            store.record(dict(e))
        snap = store.snapshot()
        snap.pop("uptime_s")
        snaps.append((snap, store.requests))
    assert snaps[1] == snaps[0]
    assert len(snaps[1][0]["recent"]) == 20 and len(snaps[1][1]) == 25


def test_generation_arguments_defaults_match_jax():
    ref = dataclasses.asdict(jeng.GenerationArguments())
    got = dataclasses.asdict(teng.GenerationArguments())
    assert ref.keys() == got.keys()
    ref.pop("request_id"), got.pop("request_id")
    assert got == ref
    assert teng.PromptTooLongError.__mro__[1] is ValueError


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("kw", [{"draft_model": types.SimpleNamespace(
    config_dict={"vocab_size": 300}, device="cpu")}])
def test_engine_refuses_unported_features(kw):
    """Speculative serving is ported: a drafter of another vocabulary than
    the target's is refused before the owner thread starts."""
    model = types.SimpleNamespace(config_dict={"vocab_size": 256},
                                  device="cpu", params={})
    with pytest.raises(ValueError, match="vocab"):
        teng.ResponseGenerator(model, None, **kw)


@pytest.mark.parametrize("kw", ["image_model_path", "detect_model_path",
                                "draft_model_path"])
def test_serve_refuses_unported_models(kw, monkeypatch):
    from mlx_vlm_tpu_torch.server import app
    from mlx_vlm_tpu_torch.utils import loader

    if kw == "draft_model_path":
        # ported: both checkpoints are read, the target's first
        read = []

        def load(path, *a, **k):
            read.append(path)
            raise FileNotFoundError(path)

        monkeypatch.setattr(loader, "load", load)
        with pytest.raises(FileNotFoundError):
            app.serve("/nonexistent/checkpoint", **{kw: "/nonexistent/other"})
        assert read == ["/nonexistent/checkpoint"]
        return
    # refused before the (nonexistent) checkpoint is read
    with pytest.raises(NotImplementedError):
        app.serve("/nonexistent/checkpoint", **{kw: "/nonexistent/other"})


@pytest.mark.parametrize("kw", ["image_service", "detection_service"])
def test_create_server_refuses_services(kw):
    from mlx_vlm_tpu_torch.server.app import create_server

    with pytest.raises(NotImplementedError):
        create_server(None, None, **{kw: object()})


def test_serve_refuses_extra_models():
    from mlx_vlm_tpu_torch.server.app import serve

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve("/nonexistent/checkpoint",
              extra_models={"other": "/nonexistent/other"})


def test_create_server_refuses_extra_models():
    from mlx_vlm_tpu_torch.server.app import create_server

    with pytest.raises(NotImplementedError, match="extra models"):
        create_server(None, None, extra_models={"other": "/x"})


def test_cli_refuses_extra_model():
    from mlx_vlm_tpu_torch.server import cli

    with pytest.raises(NotImplementedError, match="--extra-model"):
        cli.main(["--model", "/nonexistent/checkpoint", "--extra-model",
                  "other=/nonexistent/other"])


@pytest.mark.parametrize("flag", ["--draft-model", "--image-model",
                                  "--detect-model"])
def test_cli_refuses_unported_flags(flag, monkeypatch):
    from mlx_vlm_tpu_torch.server import app, cli

    if flag == "--draft-model":
        # ported: the flag and --num-draft-tokens reach serve
        seen = {}
        monkeypatch.setattr(app, "serve",
                            lambda model, **kw: seen.update(kw, model=model))
        cli.main(["--model", "/nonexistent/checkpoint", flag, "/x",
                  "--num-draft-tokens", "3"])
        assert seen["draft_model_path"] == "/x" and seen["num_draft"] == 3
        return
    with pytest.raises(NotImplementedError):
        cli.main(["--model", "/nonexistent/checkpoint", flag, "/x"])


def _python(code: str, *args):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, *args] if not code else
                          [sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_server_import_pulls_in_no_jax():
    res = _python(
        "import sys, mlx_vlm_tpu_torch.server.app, "
        "mlx_vlm_tpu_torch.server.cli, mlx_vlm_tpu_torch.structured, "
        "mlx_vlm_tpu_torch.tool_parsers, mlx_vlm_tpu_torch.vision_cache, "
        "mlx_vlm_tpu_torch.apc, mlx_vlm_tpu_torch.apc_adapters, "
        "mlx_vlm_tpu_torch.chat, mlx_vlm_tpu_torch.generate.cli\n"
        "from mlx_vlm_tpu_torch.server import openai, anthropic, responses, "
        "registry, schemas, audio, webui\n"
        "bad = [m for m in ('jax', 'mlx_vlm_tpu', 'pydantic', 'PIL', "
        "'transformers') if m in sys.modules]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    assert res.returncode == 0, res.stdout + res.stderr


def test_main_routes_server_and_refuses_the_rest():
    res = _python("", "-m", "mlx_vlm_tpu_torch", "convert")
    assert res.returncode == 2
    assert ("usage: python -m mlx_vlm_tpu_torch {generate,server,chat}"
            in res.stdout)
    assert "ported: generate, server, chat" in res.stdout
    res = _python("", "-m", "mlx_vlm_tpu_torch", "server", "--help")
    assert res.returncode == 0 and "--max-concurrency" in res.stdout


def test_cli_flags_match_jax():
    import argparse

    from mlx_vlm_tpu.server import cli as jcli
    from mlx_vlm_tpu_torch.server import cli as tcli

    seen = {}
    for mod in (jcli, tcli):
        parsers = []
        real = argparse.ArgumentParser.parse_args

        def capture(self, argv=None, namespace=None, parsers=parsers):
            parsers.append(self)
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                mod.main(["--model", "x"])
        finally:
            argparse.ArgumentParser.parse_args = real
        seen[mod] = sorted(
            (a.dest, a.default, tuple(a.choices or ()), a.required)
            for a in parsers[0]._actions)
    assert seen[tcli] == seen[jcli]


# ------------------------------------------------------------ profiling, cache
def test_phase_timer_and_annotate():
    t = tprof.PhaseTimer()
    for name in ("a", "a", "b"):
        with t.phase(name):
            pass
    with tprof.annotate("prefill", t):
        pass
    snap = t.snapshot()
    assert snap["a"]["count"] == 2 and snap["b"]["count"] == 1
    assert snap["prefill"]["count"] == 1 and snap["a"]["total_s"] >= 0
    t.reset()
    assert t.snapshot() == {}


def test_trace_if_enabled_writes_a_trace(tmp_path, monkeypatch):
    import torch

    monkeypatch.delenv("MLX_VLM_TPU_PROFILE_DIR", raising=False)
    with tprof.trace_if_enabled() as active:
        assert active is False
    monkeypatch.setenv("MLX_VLM_TPU_PROFILE_DIR", str(tmp_path))
    with tprof.trace_if_enabled("unit") as active:
        assert active is True
        with tprof.annotate("step"):
            torch.ones(8).mul(2)
    trace = json.loads((tmp_path / "unit" / "trace.json").read_text())
    assert any(e.get("name") == "step" for e in trace["traceEvents"])


def test_vision_cache_matches_jax():
    rng = np.random.default_rng(0)
    pv = rng.standard_normal((16, 12)).astype(np.float32)
    grid = np.array([[1, 4, 4]])
    assert tvc.VisionFeatureCache.key(pv, grid) == \
        jvc.VisionFeatureCache.key(pv, grid)
    assert tvc.VisionFeatureCache.key(pv) == jvc.VisionFeatureCache.key(pv)
    caches = [jvc.VisionFeatureCache(max_size=2),
              tvc.VisionFeatureCache(max_size=2)]
    for c in caches:
        for k in "abcab":
            if c.get(k) is None:
                c.put(k, k.upper())
    j, t = caches
    assert list(t._store.items()) == list(j._store.items())
    assert (t.hits, t.misses) == (j.hits, j.misses)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["w4grp", "exact"])
def test_engine_dtype_is_the_models(dtype, mode, monkeypatch):
    """The batch runs in the dtype the model was loaded in, whatever the
    dtype of a quantized weight's scales (f32 for w4grp): on the card K1
    takes only bf16 activations."""
    import torch

    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.testing import (mlx_int4_checkpoint,
                                                 tiny_qwen2_vl_config)

    monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)
    cfg, w = mlx_int4_checkpoint(tiny_qwen2_vl_config(
        hidden_size=128, intermediate_size=256,
        rope_scaling={"type": "mrope", "mrope_section": [4, 6, 6]}), seed=2)
    model = load_model_from_weights(cfg, w, getattr(torch, dtype), "cpu")
    assert teng._param_dtype(model.params) == getattr(torch, dtype)
