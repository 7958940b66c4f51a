"""Port parity: speculative serving (`create_server(draft_model=)`,
`--draft-model`), after tests/test_server.py:346-390, on the tiny f32
checkpoint (`build_tiny_checkpoint`; the port's models on the CPU), each
server started alike (2 slots, capacity 256, blocks of 2 steps, 3 drafted
tokens a round):

- a server with a drafter of another seed answers a greedy chat with the
  plain server's text and the JAX package's speculative server's;
  concurrent chats share its rounds and keep the plain answers;
- the target as its own drafter reports full acceptance in /metrics'
  "speculative" entry, with the JAX package's rounds / drafted /
  accepted;
- a sampled chat is answered;
- `kv_bits` with a drafter logs the reference's warning and serves the
  bf16 caches (the plain server's answer);
- `serve(draft_model_path=)` and `--draft-model` load the drafter and pass
  it to the engine.
"""

import json
import logging
import socket
import threading
import urllib.request

import pytest
import torch

import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.server.app import create_server as jax_create_server
from mlx_vlm_tpu.utils.testing import build_tiny_checkpoint
from mlx_vlm_tpu_torch.server import app as tapp
from mlx_vlm_tpu_torch.server.app import create_server

torch.set_num_threads(2)

K = 3


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(make, model, proc, **kw):
    port = _free_port()
    httpd = make(model, proc, model_name="tiny-qwen2-vl", host="127.0.0.1",
                 port=port, num_slots=2, capacity=256, block_size=2,
                 token_queue_timeout=120.0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{"jax": {name: (model, processor)}, "port": {...}} for the target
    (seed 11) and a drafter checkpoint of seed 12."""
    out = {"jax": {}, "port": {}}
    for name, seed in (("target", 11), ("other-seed", 12)):
        d = tmp_path_factory.mktemp(name)
        build_tiny_checkpoint(str(d), seed=seed)
        out["jax"][name] = mlx_vlm_tpu.load(str(d), dtype=jnp.float32)
        out["port"][name] = mlx_vlm_tpu_torch.load(
            str(d), dtype=torch.float32, device="cpu")
    return out


@pytest.fixture(scope="module")
def servers(models):
    """name -> (url, ResponseGenerator): the port's plain server, its
    speculative servers (drafter of another seed; the target itself) and
    the JAX package's speculative servers alike."""
    tm, tp = models["port"]["target"]
    jm, jp = models["jax"]["target"]
    started = {
        "plain": _start(create_server, tm, tp),
        "spec": _start(create_server, tm, tp,
                       draft_model=models["port"]["other-seed"][0],
                       num_draft=K),
        "self": _start(create_server, tm, tp, draft_model=tm, num_draft=K),
        "jax-spec": _start(jax_create_server, jm, jp,
                           draft_model=models["jax"]["other-seed"][0],
                           num_draft=K),
        "jax-self": _start(jax_create_server, jm, jp, draft_model=jm,
                           num_draft=K),
    }
    yield {k: (url, h.state.generator) for k, (h, url) in started.items()}
    for httpd, _ in started.values():
        httpd.shutdown()
        httpd.state.generator.shutdown()


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=120) as r:
        return json.loads(r.read())


def _chat(url, text, max_tokens=8, temperature=0.0):
    return _post(url, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": text}],
        "max_tokens": max_tokens, "temperature": temperature})


def _content(resp):
    return resp["choices"][0]["message"]["content"]


def test_greedy_chat_matches_plain_and_jax(servers):
    body = "speculate this"
    plain = _chat(servers["plain"][0], body)
    spec = _chat(servers["spec"][0], body)
    ref = _chat(servers["jax-spec"][0], body)
    assert _content(spec) == _content(plain) == _content(ref)
    assert spec["usage"] == plain["usage"] == ref["usage"]
    entry = _get(servers["spec"][0], "/metrics")["recent"][-1]
    ref_entry = _get(servers["jax-spec"][0], "/metrics")["recent"][-1]
    assert entry["speculative"] == ref_entry["speculative"]


def test_self_drafter_reports_full_acceptance(servers):
    """Drafter == target: every drafted token accepted (/metrics), the
    plain server's answer, the JAX package's counts."""
    body = "accept everything"
    got = _chat(servers["self"][0], body)
    ref = _chat(servers["jax-self"][0], body)
    assert _content(got) == _content(_chat(servers["plain"][0], body)) \
        == _content(ref)
    entry = _get(servers["self"][0], "/metrics")["recent"][-1]
    ref_entry = _get(servers["jax-self"][0], "/metrics")["recent"][-1]
    assert entry["speculative"]["acceptance_rate"] == 1.0
    assert entry["speculative"]["accepted"] >= entry["speculative"]["rounds"]
    assert entry["speculative"] == ref_entry["speculative"]


def test_sampled_chat_is_answered(servers):
    resp = _chat(servers["spec"][0], "sampled", max_tokens=4,
                 temperature=0.7)
    assert resp["choices"][0]["finish_reason"] in ("stop", "length")
    assert resp["usage"]["completion_tokens"] >= 1


def test_concurrent_chats_share_rounds(servers):
    """Two greedy chats at once advance through shared rounds and keep the
    plain server's answers; the generator counts its rounds and fetches
    (no capture on the CPU)."""
    bodies = [f"concurrent {i}" for i in range(2)]
    expected = [_content(_chat(servers["plain"][0], b)) for b in bodies]
    url, generator = servers["spec"]
    results = [None, None]

    def go(i):
        results[i] = _content(_chat(url, bodies[i]))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert results == expected
    st = generator.batch.decode.stats
    assert st["rounds"] > 0 and st["captures"] == 0
    assert st["fetches"] == st["rounds"] + st["admissions"]


def test_kv_bits_with_draft_model_warns_and_serves(models, caplog):
    tm, tp = models["port"]["target"]
    with caplog.at_level(logging.WARNING, logger="mlx_vlm_tpu_torch.server"):
        httpd, url = _start(create_server, tm, tp, kv_bits=4,
                            draft_model=models["port"]["other-seed"][0],
                            num_draft=K)
    try:
        assert any("--kv-bits is not supported with --draft-model" in
                   r.getMessage() for r in caplog.records)
        gen = httpd.state.generator
        assert type(gen.batch.cache).__name__ == "BatchKVCache"
        got = _content(_chat(url, "quantized?"))
    finally:
        httpd.shutdown()
        httpd.state.generator.shutdown()
    plain_httpd, plain_url = _start(create_server, tm, tp)
    try:
        assert got == _content(_chat(plain_url, "quantized?"))
    finally:
        plain_httpd.shutdown()
        plain_httpd.state.generator.shutdown()


def test_serve_loads_the_drafter(monkeypatch):
    """serve(draft_model_path=) loads both checkpoints with `load` before
    the server starts and hands the drafter to create_server."""
    from mlx_vlm_tpu_torch.utils import loader

    loaded, passed = [], {}

    class Done(Exception):
        pass

    def fake_load(path, *a, **k):
        loaded.append(path)
        return f"model:{path}", f"processor:{path}"

    def fake_create(model, processor, **kw):
        passed.update(kw, model=model)
        raise Done

    monkeypatch.setattr(loader, "load", fake_load)
    monkeypatch.setattr(tapp, "create_server", fake_create)
    with pytest.raises(Done):
        tapp.serve("/target", draft_model_path="/drafter", num_draft=5)
    assert loaded == ["/target", "/drafter"]
    assert passed["model"] == "model:/target"
    assert passed["draft_model"] == "model:/drafter"
    assert passed["num_draft"] == 5
