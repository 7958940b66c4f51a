"""Each served request's `usage` is its own (server/engine.py's envelope,
read by request id on the OpenAI, Anthropic and Responses routes).

The JAX package's routes read the newest envelope of the metrics store
(reference server/openai.py:136-140, :199-212; anthropic.py:141-151;
responses.py:100-102), and its engine queues a request's finishing token
before it records that request's envelope, so a handler can read another
request's prompt length, or none.  The port records first and reads by
`request_id`.  Two requests with prompts of different lengths go to one
port server at once, on each route; each answer's prompt count must be
its own prompt's token count (the route's own normalisation, tokenized by
`prepare_inputs`), and its total the prompt count plus its completion
count.  The server is the port's alone: the JAX server's answer would be
the fault under test.
"""

import json
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

import mlx_vlm_tpu_torch
from mlx_vlm_tpu.utils.testing import build_tiny_checkpoint
from mlx_vlm_tpu_torch.server.anthropic import normalize_messages_request
from mlx_vlm_tpu_torch.server.app import create_server
from mlx_vlm_tpu_torch.server.engine import ServerMetricsStore
from mlx_vlm_tpu_torch.server.openai import normalize_chat_request
from mlx_vlm_tpu_torch.server.responses import STORE, _to_generation_args
from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

torch.set_num_threads(2)

SHORT = "Hi"
LONG = "Tell me everything about lighthouses and the sea " * 6


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_qwen2_vl")
    build_tiny_checkpoint(str(d))
    model, proc = mlx_vlm_tpu_torch.load(str(d), dtype=torch.float32,
                                         device="cpu")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    httpd = create_server(model, proc, model_name="tiny", host="127.0.0.1",
                          port=port, num_slots=2, capacity=256, block_size=2,
                          token_queue_timeout=120.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{port}", model, proc
    httpd.shutdown()
    httpd.state.generator.shutdown()


def _post(url: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return json.loads(r.read())


def _prompt_len(args, proc) -> int:
    return int(np.asarray(prepare_inputs(proc, args.prompt)["input_ids"])
               .shape[1])


# route -> (path, body of a text and a budget, the route's normalisation,
#           (prompt, completion, total) read from an answer)
ROUTES = {
    "chat": ("/v1/chat/completions",
             lambda text, n: {"messages": [{"role": "user",
                                            "content": text}],
                              "max_tokens": n},
             normalize_chat_request,
             lambda a: (a["usage"]["prompt_tokens"],
                        a["usage"]["completion_tokens"],
                        a["usage"]["total_tokens"])),
    "messages": ("/v1/messages",
                 lambda text, n: {"messages": [{"role": "user",
                                                "content": text}],
                                  "max_tokens": n},
                 normalize_messages_request,
                 lambda a: (a["usage"]["input_tokens"],
                            a["usage"]["output_tokens"],
                            a["usage"]["input_tokens"]
                            + a["usage"]["output_tokens"])),
    "responses": ("/v1/responses",
                  lambda text, n: {"input": text, "max_output_tokens": n},
                  lambda body, model, proc: _to_generation_args(
                      body, model, proc, STORE)[0],
                  lambda a: (a["usage"]["input_tokens"],
                             a["usage"]["output_tokens"],
                             a["usage"]["total_tokens"])),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_concurrent_requests_get_their_own_usage(server, route):
    url, model, proc = server
    path, body_of, normalize, usage = ROUTES[route]
    # the short prompt asks for more tokens, so the long one finishes first
    bodies = [body_of(LONG, 3), body_of(SHORT, 9)]
    want = [_prompt_len(normalize(b, model, proc), proc) for b in bodies]
    assert want[0] != want[1]
    for _ in range(2):
        answers = [None, None]

        def hit(i):
            answers[i] = _post(url, path, bodies[i])

        threads = [threading.Thread(target=hit, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for answer, n_prompt in zip(answers, want):
            prompt, completion, total = usage(answer)
            assert prompt == n_prompt
            assert completion > 0
            assert total == n_prompt + completion


def test_envelope_is_looked_up_by_request_id():
    m = ServerMetricsStore()
    m.record({"request_id": "a", "prompt_tokens": 5})
    m.record({"request_id": "b", "prompt_tokens": 7})
    assert m.envelope("a")["prompt_tokens"] == 5
    assert m.envelope("b")["prompt_tokens"] == 7
    assert m.envelope("c") == {}
