"""Port parity: the decode blocks (generate/ar.py `DecodeBlocks`).

The port decodes in blocks of `block_size` steps with every piece of decode
state on the device (the cache's int32 0-dim cursor among them) and one
host fetch per block; on the card each step after the first replays one
captured CUDA graph, here on the CPU the same step runs eagerly.  Held to
the JAX package on a tiny int4 model (hidden 128, 4/2 heads, head_dim 32,
the fused-head configuration of tests/test_torch_fused_decode.py), both in
float32 on the CPU:

- greedy tokens through `stream_generate` equal the JAX package's (its
  `decode_block_fn` path) for every cache `make_cache` builds, at block
  sizes 1, 3 and 8 with max_tokens 10 (nine decode steps: at 8 the last
  block is partial), and the caches' cursors agree after prefill and after
  decode (the JAX run takes blocks of 3, so its nine steps end where the
  port's do);
- a seeded sampled request repeats exactly, at any block size;
- the plain K3 with a cursor tensor matches the JAX package's
  `fused_decode_step` (the grid kernel in interpret mode, with the JAX
  package's own z2-vs-grid bound) at offsets 1, 300 and 319 of a 320-row
  cache, and NaN past the cursor changes no bit of its outputs;
- a decode block reads nothing on the host: `.item`, `.cpu`, `.tolist`,
  `.numpy` and int() / bool() / float() / index() of a tensor raise while
  one is dispatched;
- the capacity check raises before any write.
"""

import contextlib
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.core.quant import quantize, to_int4_grouped
from mlx_vlm_tpu.generate.dispatch import stream_generate as jax_stream
from mlx_vlm_tpu.ops.fused_decode import fused_decode_step as jax_fused_step
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import qwen2_vl_hf_weights, tiny_qwen2_vl_config
from mlx_vlm_tpu_torch.core import cache as cache_lib
from mlx_vlm_tpu_torch.generate.dispatch import stream_generate
from mlx_vlm_tpu_torch.models.qwen2_vl import Model, ModelConfig
from mlx_vlm_tpu_torch.ops import _cuda
from mlx_vlm_tpu_torch.ops import fused_decode as fd
from mlx_vlm_tpu_torch.utils.loader import decide_fused_decode, params_from_jax
from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

# `generate` is also each package's function, so import by module name
jar = importlib.import_module("mlx_vlm_tpu.generate.ar")
tar = importlib.import_module("mlx_vlm_tpu_torch.generate.ar")

torch.set_num_threads(2)

MAX_TOKENS = 10
JAX_BLOCK = 3  # nine decode steps: three whole blocks
PROMPT = [int(t) for t in np.random.default_rng(6).integers(0, 256, 21)]

# cache kind -> (fused route, kv_bits, kv_group_size, environment)
KINDS = {
    "bf16-fused": (True, None, 64, {}),
    "bf16-per-linear": (False, None, 64, {}),
    "int8": (False, 8, 64, {}),
    "int4": (False, 4, 64, {}),
    "affine-4": (False, 4, 32, {"MLX_VLM_TPU_KV_SCHEME": "affine"}),
    "turboquant-3.5": (False, 3.5, 64, {}),
    "turboquant-3.5-split": (False, 3.5, 64,
                             {"MLX_VLM_TPU_TQ_SCHEME": "split"}),
    "rotated-int4": (False, 4, 64, {"MLX_VLM_TPU_KV_SCHEME": "turboquant"}),
}
ENV_KEYS = ("MLX_VLM_TPU_KV_SCHEME", "MLX_VLM_TPU_TQ_SCHEME",
            "MLX_VLM_TPU_FUSED_DECODE")


def _config():
    cfg = tiny_qwen2_vl_config()
    cfg.update(hidden_size=128, intermediate_size=256, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2,
               tie_word_embeddings=False)
    cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [4, 6, 6]}
    cfg["vision_config"]["hidden_size"] = 32
    return cfg


def _weights(cfg, seed=13):
    weights = qwen2_vl_hf_weights(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for k in list(weights):
        if ((k.startswith("model.layers.") and k.endswith(".weight")
             and "layernorm" not in k and weights[k].ndim == 2)
                or k == "lm_head.weight"):
            w = rng.standard_normal(weights[k].shape).astype(np.float32) * 0.1
            weights[k] = to_int4_grouped(quantize(jnp.asarray(w), bits=4,
                                                  group_size=64))
    return weights


@contextlib.contextmanager
def _env(**values):
    mp = pytest.MonkeyPatch()
    for k in ENV_KEYS:
        mp.delenv(k, raising=False)
    for k, v in values.items():
        mp.setenv(k, v)
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def pairs():
    """fused route -> (JAX model, port model) on the same parameters."""
    cfg = _config()
    out = {}
    for fused in (True, False):
        with _env(**({} if fused else {"MLX_VLM_TPU_FUSED_DECODE": "0"})):
            jm = jax_load(dict(cfg), _weights(cfg), jnp.float32)
            tm = Model(ModelConfig.from_dict(cfg))
            tm.params = params_from_jax(
                tm, jax.tree_util.tree_map(np.asarray, jm.params))
            tm.config_dict = cfg
            tm.device = torch.device("cpu")
            assert decide_fused_decode(tm) == fused
        assert ("fused_decode" in jm.params["language_model"]) == fused
        out[fused] = (jm, tm)
    return out


def _tokens(stream, model, **kw):
    res = list(stream(model, ByteTokenizer(), PROMPT, max_tokens=MAX_TOKENS,
                      prefill_step_size=64, **kw))
    return [r.token for r in res], [float(np.asarray(r.logprobs).reshape(-1)
                                          [0]) for r in res]


_JAX_RUNS: dict = {}


def _jax_run(pairs, kind):
    """The JAX package's greedy tokens and its cache cursor at its first
    decode block and after its last (blocks of JAX_BLOCK steps)."""
    if kind not in _JAX_RUNS:
        fused, kv_bits, group, env = KINDS[kind]
        jm = pairs[fused][0]
        engine = jar.get_engine(jm)
        make = engine.decode_block_fn
        offsets = []

        def spy(sampler, processors, block_size):
            block = make(sampler, processors, block_size)

            def run(params, cache, *a):
                offsets.append(int(cache.offset))
                out = block(params, cache, *a)
                offsets.append(int(out[2].offset))
                return out
            return run

        engine.decode_block_fn = spy
        try:
            with _env(**env):
                toks, _ = _tokens(jax_stream, jm, block_size=JAX_BLOCK,
                                  kv_bits=kv_bits, kv_group_size=group)
        finally:
            del engine.decode_block_fn
        _JAX_RUNS[kind] = toks, offsets[0], offsets[-1]
    return _JAX_RUNS[kind]


@pytest.mark.parametrize("block_size", [1, 3, 8])
@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_tokens_and_cursor_match_jax(pairs, monkeypatch, kind,
                                            block_size):
    fused, kv_bits, group, env = KINDS[kind]
    jt, j_first, j_last = _jax_run(pairs, kind)
    tm = pairs[fused][1]
    made, first = [], []
    make = tar.make_cache
    dispatch = tar.DecodeBlocks.dispatch
    monkeypatch.setattr(tar, "make_cache",
                        lambda *a, **k: made.append(make(*a, **k)) or made[-1])
    monkeypatch.setattr(
        tar.DecodeBlocks, "dispatch",
        lambda self, n: first.append(int(self.cache.offset)) or dispatch(
            self, n))
    with _env(**env):
        tt, tl = _tokens(stream_generate, tm, block_size=block_size,
                         kv_bits=kv_bits, kv_group_size=group)
    assert len(tt) == MAX_TOKENS and tt == jt
    assert np.all(np.isfinite(tl))
    cache = made[0]
    assert cache.offset.dtype == torch.int32 and cache.offset.dim() == 0
    assert first[0] == j_first == len(PROMPT)
    assert int(cache.offset) == j_last == len(PROMPT) + MAX_TOKENS - 1
    steps = MAX_TOKENS - 1
    blocks = -(-steps // block_size)
    assert len(first) == blocks
    assert tar.last_decode.cache is cache
    assert tar.last_decode.stats == dict(first_s=0.0, capture_s=0.0,
                                         steps=steps, replays=0,
                                         fetches=blocks + 1, blocks=blocks)


@pytest.mark.parametrize("fused", [True, False])
def test_seeded_sampling_repeats(pairs, fused):
    """The sampler draws from the request's generator (an exponential race,
    multinomial's own draw): a seed repeats its tokens and logprobs, and the
    block size does not change them."""
    tm = pairs[fused][1]
    kw = dict(temperature=0.9, top_p=0.95, top_k=40, min_p=0.01,
              repetition_penalty=1.1, logit_bias={65: 1.5, 66: -2.0},
              seed=7)
    with _env():
        runs = [_tokens(stream_generate, tm, block_size=bs, **kw)
                for bs in (4, 4, 1)]
        other = _tokens(stream_generate, tm, block_size=4,
                        **dict(kw, seed=8))
    assert runs[0] == runs[1] == runs[2]
    assert other[0] != runs[0][0]


def test_sampler_is_multinomials_draw():
    """The exponential race draws what torch.multinomial draws from the same
    generator state."""
    from mlx_vlm_tpu_torch.core.sampling import make_sampler

    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 500)).astype(np.float32))
    sample = make_sampler(temp=0.7)
    for seed in range(4):
        want = torch.multinomial(torch.softmax(logits / 0.7, -1), 1,
                                 generator=torch.Generator().manual_seed(
                                     seed))[:, 0]
        got = sample(logits, torch.Generator().manual_seed(seed))
        assert torch.equal(got, want)


@contextlib.contextmanager
def _no_host_reads():
    """Make every Python-level read of a tensor on the host raise."""
    def refuse(name):
        def call(*a, **k):
            raise AssertionError(f"host read {name} inside a decode block")
        return call

    names = ("item", "cpu", "tolist", "numpy", "__int__", "__bool__",
             "__float__", "__index__")
    saved = {n: torch.Tensor.__dict__.get(n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse(n))
        yield
    finally:
        for n, f in saved.items():
            if f is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_decode_block_reads_nothing_on_the_host(pairs, monkeypatch, kind):
    fused, kv_bits, group, env = KINDS[kind]
    tm = pairs[fused][1]
    dispatch = tar.DecodeBlocks.dispatch
    ran = []

    def guarded(self, n):
        with _no_host_reads():
            out = dispatch(self, n)
        ran.append(n)
        return out

    monkeypatch.setattr(tar.DecodeBlocks, "dispatch", guarded)
    with _env(**env):
        toks, _ = _tokens(stream_generate, tm, block_size=4, kv_bits=kv_bits,
                          kv_group_size=group, temperature=0.8, top_p=0.9,
                          top_k=20, min_p=0.02, repetition_penalty=1.2,
                          logit_bias={70: 1.0}, seed=3)
    assert ran == [4, 4, 1] and len(toks) == MAX_TOKENS
    with pytest.raises(AssertionError, match="host read"):
        with _no_host_reads():
            int(torch.ones(()))


def test_capacity_check_raises_before_any_write(pairs, monkeypatch):
    """A cache that holds the padded prompt but not every decode step's row
    is refused before the prefill writes anything; so is one too small for
    the padded prompt.  A write past the capacity raises, never clamps."""
    tm = pairs[False][1]
    lm = tm.language_model
    made = []

    def small(model, batch_size, capacity, dtype, *a, **k):
        made.append(lm.init_cache(batch_size, cap, dtype))
        return made[-1]

    monkeypatch.setattr(tar, "make_cache", small)
    embeds = torch.randn((1, 21, 128))
    for cap, step, max_tokens, what in ((32, 16, 20, "19 decode steps"),
                                        (48, 64, 4, "padded prompt 64")):
        made.clear()
        with pytest.raises(ValueError, match=what):
            next(tar.generate_step(embeds, tm, max_tokens=max_tokens,
                                   prefill_step_size=step))
        c = made[0]
        assert c.capacity == cap and int(c.offset) == 0
        assert not c.k.any() and not c.v.any()
    tar.check_capacity(32, 32, 21, 12)  # rows up to 21 + 11 = 32 fit
    with pytest.raises(ValueError):
        tar.check_capacity(32, 32, 21, 13)
    c = lm.init_cache(1, 8, torch.float32)
    c.offset.fill_(7)
    with pytest.raises((IndexError, RuntimeError)):
        cache_lib.update_layer(c.k[0], c.v[0], torch.ones((1, 2, 2, 32)),
                               torch.ones((1, 2, 2, 32)), c.offset)


C = 320


def _k3_inputs(pack, offset, fill, seed=2):
    L, Hkv, hd = pack.n_layers, pack.n_kv, pack.head_dim
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((1, 1, pack.dim)) * 0.3).astype(np.float32)
    cos = (rng.standard_normal(hd // 2) * 0.1 + 1.0).astype(np.float32)
    sin = (rng.standard_normal(hd // 2) * 0.1).astype(np.float32)
    k = (rng.standard_normal((L, 1, Hkv, C, hd)) * 0.2).astype(np.float32)
    v = (rng.standard_normal((L, 1, Hkv, C, hd)) * 0.2).astype(np.float32)
    k[:, :, :, offset:] = fill
    v[:, :, :, offset:] = fill
    return h, cos, sin, k, v


@pytest.mark.parametrize("offset", [1, 300, C - 1])
def test_plain_k3_with_a_cursor_tensor_matches_jax(pairs, offset):
    """The plain K3 reads its cursor as a 0-dim int32 tensor: against the
    JAX package's `fused_decode_step` (the grid kernel, dequant math) on a
    cache that holds zeros past the cursor, within the JAX package's own
    bound between that kernel and the z2 math (tests/test_fused_decode.py
    `test_manual_kernel_z2_close_to_grid`: h atol 0.25 rtol 0.05, k/v atol
    8e-2); with NaN past the cursor its outputs keep every bit, its row
    lands at the cursor and the rows after it stay NaN."""
    jm, tm = pairs[True]
    pack = jm.params["language_model"]["fused_decode"]
    lp, args = tm.params["language_model"], tm.language_model.args
    L, Hkv = pack.n_layers, pack.n_kv
    clean = _k3_inputs(pack, offset, 0.0)
    hj, kj, vj = jax_fused_step(pack, *(jnp.asarray(a) for a in clean),
                                jnp.asarray(offset, jnp.int32),
                                interpret=True)
    cursor = torch.tensor(offset, dtype=torch.int32)
    outs = {}
    for name, fill in (("zeros", 0.0), ("nan", float("nan"))):
        h, cos, sin, k, v = (torch.from_numpy(a.copy())
                             for a in _k3_inputs(pack, offset, fill))
        outs[name] = fd.fused_decode_step(lp, args, h, cos, sin, k, v,
                                          cursor), k, v
    (ht, kt, vt, _), kc, vc = outs["zeros"]
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=0.25,
                               rtol=0.05)
    for got, ref in ((kt, kj), (vt, vj)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref)[:, :Hkv].reshape(L, -1), atol=8e-2)
    nan_out, kn, vn = outs["nan"]
    assert all(torch.equal(a, b) for a, b in zip(nan_out, outs["zeros"][0]))
    assert torch.equal(kn[:, :, :, offset], kc[:, :, :, offset])
    assert torch.equal(vn[:, :, :, offset], vc[:, :, :, offset])
    assert bool(kn[:, :, :, offset + 1:].isnan().all())
    assert bool(vn[:, :, :, offset + 1:].isnan().all())
    assert int(cursor) == offset  # the step reads the cursor, never moves it


def test_captured_launches_count_at_each_replay(monkeypatch):
    """`_cuda.count` counts a launch where it executes: outside a capture at
    once; inside a `Graph` capture into the graph's tally, which each
    replay adds; inside any other capture not at all."""
    launches = {"k": 0}
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    _cuda.count(launches, "k")
    assert launches == {"k": 1}
    capturing[0] = True
    _cuda.count(launches, "k")  # a timing graph's capture
    g = _cuda.Graph.__new__(_cuda.Graph)
    g.tally = []
    g.graph = type("Replay", (), {"replay": lambda self: None})()
    _cuda._CAPTURES.append(g.tally)
    try:
        _cuda.count(launches, "k")
        _cuda.count(launches, "k")
    finally:
        _cuda._CAPTURES.pop()
    assert launches == {"k": 1} and len(g.tally) == 2
    for _ in range(3):
        g.replay()
    assert launches == {"k": 7}


@pytest.mark.parametrize("fails", [False, True])
def test_no_garbage_collection_inside_a_capture(monkeypatch, fails):
    """`Graph.capture` keeps Python's garbage collector off from the
    capture's begin to its end (a collection there could destroy another
    generator's CUDA events or graph, which invalidates the capture on the
    card), and restores it afterwards, also when the captured call
    raises."""
    import gc

    seen = []

    class FakeGraph:
        def capture_begin(self):
            seen.append(("begin", gc.isenabled()))

        def capture_end(self):
            seen.append(("end", gc.isenabled()))

    def fn():
        seen.append(("fn", gc.isenabled()))
        if fails:
            raise RuntimeError("capture failed")

    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    g = _cuda.Graph.__new__(_cuda.Graph)
    g.graph, g.tally = FakeGraph(), []
    assert gc.isenabled()
    with contextlib.suppress(RuntimeError):
        g.capture(fn, None)
    assert seen == [("begin", False), ("fn", False), ("end", False)]
    assert gc.isenabled() and not _cuda._CAPTURES


def test_cursor_is_a_device_tensor_in_every_cache(pairs):
    """Every cache `make_cache` builds keeps its cursor as an int32 0-dim
    tensor on its device, advanced in place."""
    tm = pairs[False][1]
    for kind, (_, kv_bits, group, env) in KINDS.items():
        with _env(**env):
            c = tar.make_cache(tm, 1, 256, torch.float32, kv_bits, group,
                               device="cpu")
        word = c.offset
        assert word.dtype == torch.int32 and word.dim() == 0, kind
        c.advance(5)
        assert c.offset is word and int(word) == 5, kind
