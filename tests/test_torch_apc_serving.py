"""Port parity: prefix caching on the entry points: stream_generate over two
turns in both APC modes, the server with APC_ENABLED, and the `chat` and
`generate` commands, each against the JAX package on the same parameters
(float32 on the CPU).

- block mode on the tiny checkpoint (`build_tiny_checkpoint`): the second
  turn of a chat hits the first turn's blocks, and its greedy tokens equal
  the JAX package's warm turn and the port's own cold turn; the vision
  cache serves an image's second turn;
- exact mode at kv_bits=4 on test_torch_batch.py's head-dim-256 model (the
  reference's 4-bit route takes its Pallas kernel in interpret mode): the
  second turn restores the first turn's snapshot;
- the server with APC_ENABLED=1: two chats sharing a system prompt, one
  hit, the answers of the JAX package's APC server and of the port's
  server without APC; /v1/cache/stats and /v1/cache/reset;
- reference fault (b): APC on a kv_bits=4 server.  The JAX package builds
  a bf16 warm cache for every request and its admission fails copying it
  into the 4-bit batch cache; the port's engine takes no warm cache and
  no harvest there, and answers as without APC;
- `python -m mlx_vlm_tpu_torch chat` / `generate` through `main(argv)`
  with `--device cpu`, printing the reference's replies.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu import apc as japc
from mlx_vlm_tpu.generate.dispatch import stream_generate as jstream
from mlx_vlm_tpu.utils.testing import build_tiny_checkpoint
from mlx_vlm_tpu_torch import apc as tapc
from mlx_vlm_tpu_torch.generate.dispatch import stream_generate as tstream
from test_torch_batch import hd256  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_qwen2_vl")
    build_tiny_checkpoint(str(d))
    return d


@pytest.fixture(scope="module")
def models(ckpt):
    """{"jax": (model, processor), "port": (model, processor)}, f32."""
    return {"jax": mlx_vlm_tpu.load(str(ckpt), dtype=jnp.float32),
            "port": mlx_vlm_tpu_torch.load(str(ckpt), dtype=torch.float32,
                                           device="cpu")}


def _template(pkg, model, proc, messages, n_img=0):
    mod = mlx_vlm_tpu if pkg == "jax" else mlx_vlm_tpu_torch
    return mod.apply_chat_template(proc, model.config_dict, messages,
                                   num_images=n_img)


def _run(pkg, model, proc, prompt, **kw):
    """(token ids, text) of one stream_generate call."""
    stream = jstream if pkg == "jax" else tstream
    res = list(stream(model, proc, prompt, **kw))
    return [r.token for r in res], "".join(r.text for r in res)


def _image():
    return np.random.default_rng(3).integers(0, 256, (56, 56, 3),
                                             dtype=np.uint8)


@pytest.mark.parametrize("with_image", [False, True])
def test_block_mode_second_turn_matches(models, with_image):
    """Two chat turns through stream_generate(apc=, vision_cache=): the
    second hits the first's blocks; its tokens equal the JAX package's warm
    turn and the port's cold turn; with an image the tower runs once."""
    from mlx_vlm_tpu.vision_cache import VisionFeatureCache as JVC
    from mlx_vlm_tpu_torch.vision_cache import VisionFeatureCache as TVC

    first = ("Describe the picture please, thank you very much. " * 3
             + "What is in this image?")
    img = [_image()] if with_image else None
    user1 = ([{"type": "image"}] if with_image else []) + [
        {"type": "text", "text": first}]
    out = {}
    for pkg in ("jax", "port"):
        model, proc = models[pkg]
        mod = japc if pkg == "jax" else tapc
        apc = mod.APCManager(num_blocks=256, block_size=16)
        vc = (JVC if pkg == "jax" else TVC)()
        msgs = [{"role": "user", "content": user1}]
        t1 = _run(pkg, model, proc, _template(pkg, model, proc, msgs,
                                              int(with_image)),
                  image=img, max_tokens=6, apc=apc, vision_cache=vc)
        assert apc.stats.hits == 0 and apc.stats.stores > 0
        msgs += [{"role": "assistant", "content": t1[1]},
                 {"role": "user", "content": "And the cat? Thank you."}]
        p2 = _template(pkg, model, proc, msgs, int(with_image))
        t2 = _run(pkg, model, proc, p2, image=img, max_tokens=6, apc=apc,
                  vision_cache=vc)
        out[pkg] = (t1, t2, apc.stats.as_dict(), vc.misses, vc.hits, p2)
    (j1, j2, jst, jmiss, jhit, p2), (t1, t2, tst, tmiss, thit, _) = (
        out["jax"], out["port"])
    assert t1 == j1 and t2 == j2 and tst == jst
    assert tst["hits"] == 1 and tst["hit_tokens"] > 0
    assert (tmiss, thit) == (jmiss, jhit)
    if with_image:
        assert (tmiss, thit) == (1, 1)
    model, proc = models["port"]
    cold = _run("port", model, proc, p2, image=img, max_tokens=6)
    assert cold == t2


def _ids_proc():
    class Tok:
        eos_token_id = 9999

        def decode(self, ids, **kw):
            return "".join(chr(97 + (int(i) % 26)) for i in ids)

    class Proc:
        tokenizer = Tok()

    return Proc()


def test_exact_mode_second_turn_matches(hd256):
    """kv_bits=4 (model_apc_mode "exact"): turn 2 = turn 1's prompt, its
    reply and 20 more tokens restores turn 1's snapshot (20 tokens, past
    the guard of 16) in both packages, with the tokens of the cold turn."""
    proc = _ids_proc()
    ids1 = (np.arange(20) * 7 % 200)[None]
    out = {}
    for pkg, model in zip(("jax", "port"), hd256):
        mod = japc if pkg == "jax" else tapc
        apc = mod.APCManager(num_blocks=64, block_size=16)
        kw = dict(max_tokens=6, kv_bits=4, apc=apc)
        t1, _ = _run(pkg, model, proc, ids1, **kw)
        ids2 = np.concatenate([ids1, np.asarray(t1)[None],
                               (np.arange(20) * 3 % 200 + 1)[None]], axis=1)
        t2, _ = _run(pkg, model, proc, ids2, **kw)
        out[pkg] = (t1, t2, apc.stats.as_dict(), ids2)
    assert out["port"][:3] == out["jax"][:3]
    assert out["port"][2]["hits"] == 1
    assert out["port"][2]["hit_tokens"] == 20
    cold, _ = _run("port", hd256[1], proc, out["port"][3], max_tokens=6,
                   kv_bits=4)
    assert cold == out["port"][1]


# ------------------------------------------------------------ the server
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url, path, body=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(body or {}).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=120) as r:
        return json.loads(r.read())


def _serve(make, model, proc, **kw):
    httpd = make(model, proc, model_name="tiny-qwen2-vl", host="127.0.0.1",
                 port=_free_port(), num_slots=2, capacity=256, block_size=2,
                 token_queue_timeout=120.0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.state.generator.shutdown()


SYSTEM = "You describe pictures. Be brief and kind. " * 4


def _two_chats(url):
    out = []
    for q in ("What is in this image?", "Describe the picture please."):
        ans = _post(url, "/v1/chat/completions", {"messages": [
            {"role": "system", "content": SYSTEM},
            {"role": "user", "content": q}], "max_tokens": 6})
        out.append((ans["choices"][0]["message"]["content"], ans["usage"]))
    return out


def test_apc_server_answers_with_one_hit(models, monkeypatch):
    """APC_ENABLED=1: the second chat hits the first's blocks; both answers
    equal the JAX package's APC server's and the port's server without
    APC; the cache routes serve the manager."""
    from mlx_vlm_tpu.server.app import create_server as jcreate
    from mlx_vlm_tpu_torch.server.app import create_server as tcreate

    answers, stats = {}, {}
    for name, make, pkg, env in (("jax", jcreate, "jax", "1"),
                                 ("port", tcreate, "port", "1"),
                                 ("port-cold", tcreate, "port", "0")):
        monkeypatch.setenv("APC_ENABLED", env)
        httpd, url = _serve(make, *models[pkg])
        try:
            answers[name] = _two_chats(url)
            stats[name] = _get(url, "/v1/cache/stats")
            if name == "port":
                assert _post(url, "/v1/cache/reset") == {"status": "ok"}
                after = _get(url, "/v1/cache/stats")
                assert after["used_blocks"] == 0
        finally:
            _stop(httpd)
    assert answers["port"] == answers["jax"] == answers["port-cold"]
    st = stats["port"]
    assert st == stats["jax"]
    assert (st["enabled"], st["lookups"], st["hits"]) == (True, 2, 1)
    assert st["hit_tokens"] > 0 and st["hit_tokens"] % 16 == 0
    assert stats["port-cold"] == {"enabled": False}


def test_apc_on_a_quantized_batch_cache(models):
    """Reference fault (b): with kv_bits=4 and APC the JAX package's
    `_prepare` builds a bf16 warm cache (apc.py:840 calls make_cache
    without kv_bits) and its admission fails copying that cache into the
    4-bit batch cache (insert_row pairs bf16 K with 4-bit codes): the
    request gets an error.  The port's engine asks model_apc_mode for the
    batch's kv_bits, sets no warm cache and no harvest where it is not
    "block", and answers as a server without APC does."""
    from mlx_vlm_tpu.server.engine import (GenerationArguments as JArgs,
                                           ResponseGenerator as JGen)
    from mlx_vlm_tpu_torch.server.engine import (GenerationArguments as TArgs,
                                                 ResponseGenerator as TGen)

    def ask(Gen, Args, pkg, apc):
        model, proc = models[pkg]
        gen = Gen(model, proc, num_slots=2, capacity=256, block_size=2,
                  apc=apc, kv_bits=4, token_queue_timeout=120.0)
        try:
            prompt = _template(pkg, model, proc, "What is in this image?")
            toks = list(gen.generate(Args(prompt=prompt, max_tokens=5)))
        finally:
            gen.shutdown()
        return ([t.error for t in toks if t.error],
                "".join(t.text for t in toks), apc)

    jerr, _, _ = ask(JGen, JArgs, "jax", japc.APCManager())
    assert jerr, "the JAX package answered a kv_bits=4 APC request"
    terr, text, apc = ask(TGen, TArgs, "port", tapc.APCManager())
    assert not terr
    assert apc.stats.lookups == 0 and not apc.blocks
    assert ask(TGen, TArgs, "port", None)[:2] == ([], text)


# ------------------------------------------------------------ the commands
def _f32(monkeypatch):
    """Both packages' `load` in float32 (the commands load bfloat16)."""
    from mlx_vlm_tpu.utils import loader as jl
    from mlx_vlm_tpu_torch.utils import loader as tl

    jload, tload = jl.load, tl.load
    monkeypatch.setattr(jl, "load", lambda p, **k: jload(p,
                                                          dtype=jnp.float32))
    monkeypatch.setattr(tl, "load", lambda p, device="cuda", **k: tload(
        p, dtype=torch.float32, device=device))


def test_chat_command_prints_the_references_replies(ckpt, monkeypatch,
                                                    capsys):
    from mlx_vlm_tpu import chat as jchat
    from mlx_vlm_tpu_torch import chat as tchat

    _f32(monkeypatch)
    made = []

    class Recording(tapc.APCManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(tapc, "APCManager", Recording)
    script = ["Hello there friend", "", "What is in this image? Thank you.",
              "/reset", "Describe the picture please.", "/exit"]
    printed = {}
    for name, main, extra in (("jax", jchat.main, []),
                              ("port", tchat.main, ["--device", "cpu"])):
        lines = iter(script)
        monkeypatch.setattr("builtins.input", lambda _p="": next(lines))
        main(["--model", str(ckpt), "--max-tokens", "6", "--apc"] + extra)
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert "(context cleared)" in printed["port"]
    (apc,), = [made]
    assert apc.stats.lookups == 3 and apc.stats.hits == 1


def test_generate_command_prints_the_references_text(ckpt, monkeypatch,
                                                     capsys):
    from mlx_vlm_tpu.generate import cli as jcli
    from mlx_vlm_tpu_torch.generate import cli as tcli

    _f32(monkeypatch)
    printed = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        main(["--model", str(ckpt), "--prompt", "Hello there friend",
              "--max-tokens", "8"] + extra)
        printed[name] = capsys.readouterr().out.splitlines()
    assert printed["port"][0] == printed["jax"][0]
    assert [ln.split(":")[0] for ln in printed["port"][1:]] == [
        "Prompt", "Generation", "Peak memory"]


def _python(*args, code=None):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    cmd = [sys.executable, "-c", code] if code else [sys.executable, *args]
    return subprocess.run(cmd, cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("cmd", ["generate", "chat"])
def test_main_routes_the_commands(cmd):
    res = _python("-m", "mlx_vlm_tpu_torch", cmd, "--help")
    assert res.returncode == 0 and "--max-tokens" in res.stdout
    assert "--device" in res.stdout


def test_apc_modules_import_no_jax():
    res = _python(code=(
        "import sys, mlx_vlm_tpu_torch.apc, mlx_vlm_tpu_torch.apc_adapters, "
        "mlx_vlm_tpu_torch.chat, mlx_vlm_tpu_torch.generate.cli\n"
        "bad = [m for m in ('jax', 'mlx_vlm_tpu', 'ml_dtypes', "
        "'safetensors', 'pydantic') if m in sys.modules]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"))
    assert res.returncode == 0, res.stdout + res.stderr
