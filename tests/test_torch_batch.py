"""Port parity: continuous batching (generate/batch.py `BatchGenerator`,
`batch_generate`) and the per-row caches it runs on.

Both packages run in float32 on the CPU, on the same parameters (the port
gets them through `params_from_jax`):

- a tiny Qwen2-VL with head dim 256 (hidden 512, 2 heads over 1 KV head, 2
  layers, int4 linears): there the reference's 4-bit batch decode takes its
  Pallas kernel (interpret mode), whose arithmetic K6's plain version
  follows, so greedy tokens are held EQUAL to the JAX package's for the
  bf16, int8, int4, rotated-int4 and group-affine per-row caches, and for
  late insertion, queue overflow, EOS, single and chunked batched
  admission; logprobs within 1e-4 (5e-3 where K6 rounds p * vs to bf16);
- the reference's own tiny model (`make_tiny_qwen2_vl(seed=3)`) for the
  cases of tests/test_quantized_kv.py::TestBatchQuantizedKV: kv_bits 8 / 4
  batches track the bf16 batch by the reference's floors and equal the
  single-stream decode at the same bits.

Also: `insert_row` byte-equal to the reference's for every cache class at
src_row 0 and 1 (source capacity below and above the batch's), the
per-row scatter of `update_layer` against `update_layer_rows`, the
per-row cursors `make_cache` builds, the TurboQuant rule (the reference's
batch fails at its first admission, the port refuses at construction),
K3 never taken by a batch cache, a batch decode
block reading nothing on the host, and the captured state rewritten in
place across admissions.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.core import cache as jcache
from mlx_vlm_tpu.core import turboquant as jtq
from mlx_vlm_tpu.generate import batch as jbatch
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import make_tiny_qwen2_vl, tiny_qwen2_vl_config
from mlx_vlm_tpu_torch.core import cache as tcache
from mlx_vlm_tpu_torch.core import turboquant as ttq
from mlx_vlm_tpu_torch.generate import batch as tbatch
from mlx_vlm_tpu_torch.models.qwen2_vl import Model, ModelConfig
from mlx_vlm_tpu_torch.utils.loader import params_from_jax
from test_torch_decode_blocks import _env, _no_host_reads, _weights

jar = importlib.import_module("mlx_vlm_tpu.generate.ar")
tar = importlib.import_module("mlx_vlm_tpu_torch.generate.ar")

torch.set_num_threads(2)

# cache kind -> (kv_bits, environment, logprob tolerance)
KINDS = {
    "bf16": (None, {}, 1e-4),
    "int8": (8, {}, 1e-4),
    "int4": (4, {}, 5e-3),
    "rotated-int4": (4, {"MLX_VLM_TPU_KV_SCHEME": "turboquant"}, 5e-3),
    "affine-4": (4, {"MLX_VLM_TPU_KV_SCHEME": "affine"}, 1e-4),
}
# the reference's class name of each kind's batch cache -> the port's
CLASS_NAMES = {"BatchKVCache": "BatchKVCache", "Int8KVCache": "Int8KVCache",
               "Int4KVCache": "Int4KVCache",
               "_RotatedInt4": "RotatedInt4KVCache",
               "QuantizedKVCache": "QuantizedKVCache"}
PROMPTS = [(np.arange(9) * 5 % 200)[None], (np.arange(14) * 3 % 200)[None],
           (np.arange(5) * 11 % 200)[None]]


def _port(jm, cfg):
    tm = Model(ModelConfig.from_dict(cfg))
    tm.params = params_from_jax(tm, jax.tree_util.tree_map(np.asarray,
                                                           jm.params))
    tm.config_dict = cfg
    tm.device = torch.device("cpu")
    return tm


@pytest.fixture(scope="module")
def hd256():
    """(JAX model, port model): head dim 256, int4 linears, f32."""
    cfg = tiny_qwen2_vl_config()
    cfg.update(hidden_size=512, intermediate_size=256, num_attention_heads=2,
               num_key_value_heads=1, num_hidden_layers=2,
               tie_word_embeddings=False)
    cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [32, 48, 48]}
    cfg["vision_config"]["hidden_size"] = 32
    with _env(MLX_VLM_TPU_FUSED_DECODE="0"):
        jm = jax_load(dict(cfg), _weights(cfg), jnp.float32)
    tm = _port(jm, cfg)
    assert tm.language_model.head_dim == 256
    return jm, tm


@pytest.fixture(scope="module")
def ref_pair():
    """The reference's own test model (tests/test_batch.py) and its port."""
    jm = make_tiny_qwen2_vl(seed=3, dtype=jnp.float32)
    return jm, _port(jm, tiny_qwen2_vl_config())


def _api(pkg: str, model):
    """The one package's batch API on `model`, as a namespace."""
    if pkg == "jax":
        embed = jax.jit(model.get_input_embeddings)
        return types.SimpleNamespace(
            Gen=jbatch.BatchGenerator, Req=jbatch.BatchRequest,
            SP=jbatch.SamplingParams, dtype=jnp.float32, model=model,
            embeds=lambda ids: embed(model.params, jnp.asarray(ids)))
    return types.SimpleNamespace(
        Gen=tbatch.BatchGenerator, Req=tbatch.BatchRequest,
        SP=tbatch.SamplingParams, dtype=torch.float32, model=model,
        embeds=lambda ids: model.get_input_embeddings(
            model.params, torch.from_numpy(np.asarray(ids, np.int64))))


def _drain(gen, uids, out=None):
    out = out if out is not None else {u: [] for u in uids}
    for _ in range(200):
        if not (gen.num_active or gen.queue):
            break
        for uid, pairs in gen.next().items():
            out[uid].extend(pairs)
    return out


def _batch(api, prompts, max_tokens=6, gen_kw=None, req_kw=None):
    """Prompts inserted at once, drained -> ({uid: [(tok, lp)]}, gen)."""
    gen = api.Gen(api.model, dtype=api.dtype,
                  **dict(dict(num_slots=4, capacity=256, block_size=3),
                         **(gen_kw or {})))
    for uid, p in enumerate(prompts):
        gen.insert(api.Req(uid=uid, inputs_embeds=api.embeds(p),
                           max_tokens=max_tokens, **(req_kw or {}).get(
                               uid, {})))
    return _drain(gen, range(len(prompts))), gen


def _assert_same(ref, got, tol):
    assert set(ref) == set(got)
    for uid in ref:
        assert [t for t, _ in got[uid]] == [t for t, _ in ref[uid]], uid
        np.testing.assert_allclose([lp for _, lp in got[uid]],
                                   [lp for _, lp in ref[uid]], rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_rows_match_jax(hd256, kind):
    """Three cold prompts admitted in one batched prefill, decoded in
    blocks of 3: tokens equal to the JAX package's, logprobs within the
    kind's tolerance, the same cache class, per-row int32 [B] cursors."""
    kv_bits, env, tol = KINDS[kind]
    jm, tm = hd256
    with _env(**env):
        ref, jgen = _batch(_api("jax", jm), PROMPTS,
                           gen_kw=dict(kv_bits=kv_bits))
        got, tgen = _batch(_api("torch", tm), PROMPTS,
                           gen_kw=dict(kv_bits=kv_bits))
    _assert_same(ref, got, tol)
    assert all(len(v) == 6 for v in got.values())
    assert CLASS_NAMES[type(jgen.cache).__name__] == type(tgen.cache).__name__
    assert jgen.cache.offset.shape == (4,)
    assert tgen.cache.offset.dtype == torch.int32
    assert tgen.cache.offset.shape == (4,)


def _late_insert(api):
    p1 = (np.arange(8) % 200)[None]
    p2 = (np.arange(6) * 7 % 200)[None]
    gen = api.Gen(api.model, num_slots=2, capacity=256, block_size=2,
                  dtype=api.dtype)
    gen.insert(api.Req(uid="a", inputs_embeds=api.embeds(p1), max_tokens=10))
    out = {"a": [], "b": []}
    for uid, pairs in gen.next().items():
        out[uid].extend(pairs)
    gen.insert(api.Req(uid="b", inputs_embeds=api.embeds(p2), max_tokens=5))
    return _drain(gen, None, out)


def _overflow(api):
    prompts = [(np.arange(4 + i) % 200)[None] for i in range(5)]
    return _batch(api, prompts, 4, dict(num_slots=2, block_size=2))[0]


def _eos(api):
    p = (np.arange(6) % 200)[None]
    toks = [t for t, _ in _batch(api, [p], 8, dict(num_slots=2,
                                                   block_size=2))[0][0]]
    return _batch(api, [p], 8, dict(num_slots=2, block_size=2),
                  {0: dict(eos_ids=(toks[2],))})[0]


def _single(api):
    """One request, then another once it is done: single admissions only."""
    gen = api.Gen(api.model, num_slots=2, capacity=256, block_size=4,
                  dtype=api.dtype)
    out = {0: [], 1: []}
    for uid, p in enumerate(PROMPTS[:2]):
        gen.insert(api.Req(uid=uid, inputs_embeds=api.embeds(p),
                           max_tokens=7))
        _drain(gen, None, out)
    return out


def _chunked(api):
    """Prompts longer than prefill_step admit in ONE chunked batched
    prefill (two chunks of 64)."""
    prompts = [(np.arange(100) * 5 % 200)[None],
               (np.arange(73) * 3 % 200)[None]]
    return _batch(api, prompts, 5, dict(capacity=512, prefill_step_size=64))[0]


SCENARIOS = {"late-insert": _late_insert, "queue-overflow": _overflow,
             "eos": _eos, "single-admission": _single,
             "chunked-batched-admission": _chunked}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scheduling_matches_jax(hd256, scenario):
    """The reference's scheduling cases (tests/test_batch.py) through both
    packages on the bf16 batch cache: every row's tokens equal, logprobs
    within 1e-4; each ends as the reference's test requires."""
    jm, tm = hd256
    with _env():
        ref = SCENARIOS[scenario](_api("jax", jm))
        got = SCENARIOS[scenario](_api("torch", tm))
    _assert_same(ref, got, 1e-4)
    if scenario == "late-insert":
        assert len(got["a"]) == 10 and len(got["b"]) == 5
    elif scenario == "queue-overflow":
        assert [len(got[u]) for u in range(5)] == [4] * 5
    elif scenario == "eos":
        assert len(got[0]) == 3
    elif scenario == "single-admission":
        assert [len(got[u]) for u in range(2)] == [7, 7]


def test_mixed_sampling_params(hd256):
    """A sampled row beside a greedy one: the greedy row equals the JAX
    package's (the sampled row draws from each package's own generator)."""
    jm, tm = hd256
    runs = {}
    for pkg, model in (("jax", jm), ("torch", tm)):
        api = _api(pkg, model)
        kw = {1: dict(sampling=api.SP(temp=1.0, top_p=0.9, top_k=50))}
        runs[pkg] = _batch(api, PROMPTS[:2], 5,
                           dict(num_slots=2, block_size=2), kw)[0]
    _assert_same({0: runs["jax"][0]}, {0: runs["torch"][0]}, 1e-4)
    assert len(runs["torch"][1]) == 5


class _StubTok:
    eos_token_id = 999

    def decode(self, ids, **kw):
        return " ".join(str(i) for i in ids)

    def __call__(self, text, **kw):
        ids = [int(x) % 200 for x in str(text).split()]
        return {"input_ids": np.asarray([ids]),
                "attention_mask": np.ones((1, len(ids)), np.int64)}


class _StubProc:
    tokenizer = _StubTok()

    def __call__(self, text=None, images=None, videos=None, **kw):
        return self.tokenizer(text[0] if isinstance(text, list) else text)


def test_batch_generate_texts_match_jax(hd256):
    """batch_generate with the stub tokenizer: texts equal in input order,
    the reference's stats keys, 8 tokens generated."""
    jm, tm = hd256
    prompts = ["1 2 3 4", "5 6 7", "8 9 10 11 12"]
    ref = jbatch.batch_generate(jm, _StubProc(), prompts, max_tokens=4,
                                num_slots=2, capacity=256)
    got = tbatch.batch_generate(tm, _StubProc(), prompts, max_tokens=4,
                                num_slots=2, capacity=256)
    assert got.texts == ref.texts and len(got.texts) == 3
    assert set(got.stats) == set(ref.stats)
    assert got.stats["generation_tokens"] == 12
    assert got.stats["prompt_tokens"] == ref.stats["prompt_tokens"]
    assert got.generator_stats["admissions"] == 2
    for name in ("min_p", "kv_bits"):  # batch_generate runs a bf16 cache
        with pytest.raises(TypeError, match=name):
            tbatch.batch_generate(tm, _StubProc(), prompts, **{name: 4})


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_bits_batch_tracks_bf16(ref_pair, bits):
    """tests/test_quantized_kv.py::TestBatchQuantizedKV on the port: the
    per-row quantized batch tracks the bf16 batch by the reference's
    floors (all but 2 tokens at 8 bits, half at 4)."""
    tm = ref_pair[1]
    api = _api("torch", tm)
    kw = dict(block_size=2)
    ref = _batch(api, PROMPTS, 6, kw)[0]
    got, gen = _batch(api, PROMPTS, 6, dict(kw, kv_bits=bits))
    assert type(gen.cache).__name__ == {8: "Int8KVCache",
                                        4: "Int4KVCache"}[bits]
    assert gen.cache.offset.dim() == 1
    total = agree = 0
    for uid in ref:
        assert len(got[uid]) == 6
        total += 6
        agree += sum(a[0] == b[0] for a, b in zip(ref[uid], got[uid]))
    assert agree >= (total - 2 if bits == 8 else total // 2)


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_bits_batch_matches_single_stream(ref_pair, bits):
    """A batched row reproduces the single-stream decode at the same bits
    token for token, in the port as in the reference."""
    jm, tm = ref_pair
    p = (np.arange(11) * 7 % 200)[None]
    e = tm.get_input_embeddings(tm.params, torch.from_numpy(p))
    single = [int(t[0]) for t, _ in tar.generate_step(e, tm, max_tokens=6,
                                                      kv_bits=bits)]
    got = _batch(_api("torch", tm), [p], 6,
                 dict(block_size=2, kv_bits=bits))[0][0]
    assert [t for t, _ in got] == single


# ------------------------------------------------------------ the caches

NL, NB, NKV, D = 2, 4, 2, 32
CACHE_KINDS = ("bf16", "int8", "int4", "rotated-int4", "affine-4")


def _make_caches(kind, B, C, per_row):
    """The same kind of cache from both packages, zero-filled."""
    dims = (NL, B, NKV, D, C)
    if kind == "bf16":
        if per_row:
            return (jcache.init_batch_cache(*dims, jnp.float32),
                    tcache.init_batch_cache(*dims, torch.float32))
        return (jcache.init_cache(*dims, jnp.float32),
                tcache.init_cache(*dims, torch.float32))
    if kind == "int8":
        return (jcache.init_int8_cache(*dims, per_row=per_row),
                tcache.init_int8_cache(*dims, per_row=per_row))
    if kind == "int4":
        return (jcache.init_int4_cache(*dims, per_row=per_row),
                tcache.init_int4_cache(*dims, per_row=per_row))
    if kind == "rotated-int4":
        return (jtq.make_rotated_int4_cache(*dims, per_row=per_row),
                ttq.make_rotated_int4_cache(*dims, per_row=per_row))
    return (jcache.init_quantized_cache(*dims, jnp.float32, bits=4,
                                        group_size=16, per_row=per_row),
            tcache.init_quantized_cache(*dims, torch.float32, bits=4,
                                        group_size=16, per_row=per_row))


def _fill(jc, tc, rng):
    """Random contents, the same bytes in both caches."""
    arrays = []
    for a in jc.scan_arrays():
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            info = np.iinfo(a.dtype)
            arrays.append(rng.integers(info.min, info.max + 1, a.shape,
                                       dtype=a.dtype))
        else:
            arrays.append(rng.standard_normal(a.shape).astype(a.dtype))
    jc = jc.with_arrays(tuple(jnp.asarray(a) for a in arrays), 0)
    for buf, a in zip(tcache.cache_buffers(tc), arrays):
        buf.copy_(torch.from_numpy(a))
    return jc


@pytest.mark.parametrize("src_cap", [64, 256])
@pytest.mark.parametrize("src_row", [0, 1])
@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_insert_row_bytes_match_jax(kind, src_row, src_cap):
    """insert_row copies rows [0, min(C_src, C)) of the source row into the
    slot, in place, and sets its cursor and left_pad: every buffer's bytes,
    the cursors and left_pad equal the reference's.  Code planes (rank 5)
    and per-token planes (rank 4) alike; a source past the batch's
    capacity is cut to it."""
    rng = np.random.default_rng(src_row * 7 + src_cap)
    jb, tb = _make_caches(kind, NB, 128, per_row=True)
    jr, tr = _make_caches(kind, 2, src_cap, per_row=False)
    jb, jr = _fill(jb, tb, rng), _fill(jr, tr, rng)
    offs = np.array([5, 17, 0, 99], np.int32)
    jb = dataclasses.replace(jb, offset=jnp.asarray(offs),
                             left_pad=jnp.asarray([1, 2, 3, 4], jnp.int32))
    tb.offset.copy_(torch.from_numpy(offs))
    tb.left_pad.copy_(torch.tensor([1, 2, 3, 4]))
    buffers = [b.data_ptr() for b in tcache.cache_buffers(tb)]
    want = jcache.insert_row(jb, jr, jnp.asarray(2, jnp.int32),
                             jnp.asarray(37, jnp.int32), src_row=src_row)
    tcache.insert_row(tb, tr, 2, 37, src_row=src_row)
    assert [b.data_ptr() for b in tcache.cache_buffers(tb)] == buffers
    for a, b in zip(want.scan_arrays(), tcache.cache_buffers(tb)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        assert a.tobytes() == b.numpy().tobytes()
    assert np.array_equal(np.asarray(want.offset), tb.offset.numpy())
    assert np.array_equal(np.asarray(want.left_pad), tb.left_pad.numpy())


@pytest.mark.parametrize("S", [1, 3])
def test_per_row_writes_match_jax(S):
    """A [B] cursor writes row b at offsets[b] + arange(S): the codes'
    scatter against update_layer_rows, the per-token planes' against
    _update_scalar_auto, bit for bit."""
    rng = np.random.default_rng(S)
    B, H, C = 3, 2, 16
    offs = np.array([0, 7, 16 - S], np.int32)
    kc, vc = (rng.standard_normal((B, H, C, 8)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, H, S, 8)).astype(np.float32)
              for _ in range(2))
    jk, jv = jcache.update_layer_rows(*(jnp.asarray(a) for a in
                                        (kc, vc, kn, vn, offs)))
    tk, tv = (torch.from_numpy(a.copy()) for a in (kc, vc))
    tcache.update_layer(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                        torch.from_numpy(offs))
    assert np.array_equal(np.asarray(jk), tk.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())
    sa, sb = kc[..., 0].copy(), vc[..., 0].copy()
    na, nb = kn[..., 0].copy(), vn[..., 0].copy()
    ja, jb = jcache._update_scalar_auto(*(jnp.asarray(a) for a in
                                          (sa, sb, na, nb, offs)))
    ta, tb = torch.from_numpy(sa), torch.from_numpy(sb)
    tcache._update_scalar(ta, tb, torch.from_numpy(na), torch.from_numpy(nb),
                          torch.from_numpy(offs))
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("kind", list(KINDS))
def test_make_cache_per_row_matches_jax(hd256, kind):
    """make_cache(per_row=True) gives the reference's cache class with an
    int32 [B] device cursor on every quantized branch; the bf16 branch
    ignores per_row in both packages (BatchGenerator builds its own)."""
    kv_bits, env, _ = KINDS[kind]
    jm, tm = hd256
    with _env(**env):
        jc = jar.make_cache(jm, 3, 256, jnp.float32, kv_bits, per_row=True)
        tc = tar.make_cache(tm, 3, 256, torch.float32, kv_bits, per_row=True,
                            device="cpu")
    want = CLASS_NAMES.get(type(jc).__name__, type(jc).__name__)
    assert type(tc).__name__ == want
    assert tuple(tc.offset.shape) == jc.offset.shape
    assert tc.offset.dtype == torch.int32
    assert tc.offset.shape == ((3,) if kv_bits else ())


@pytest.mark.parametrize("scheme", [None, "split"])
def test_turboquant_batch_is_refused(hd256, scheme):
    """kv_bits 3.5: the reference builds its TurboQuant batch cache with a
    0-dim cursor and fails at the first admission (IndexError in
    insert_row, after the prefill); the port raises before any work."""
    jm, tm = hd256
    with _env(MLX_VLM_TPU_TQ_SCHEME=scheme) if scheme else _env():
        jgen = jbatch.BatchGenerator(jm, num_slots=2, capacity=256,
                                     dtype=jnp.float32, kv_bits=3.5)
        jgen.insert(jbatch.BatchRequest(
            uid=0, inputs_embeds=_api("jax", jm).embeds(PROMPTS[0]),
            max_tokens=3))
        with pytest.raises(IndexError):
            jgen.next()
        with pytest.raises(ValueError, match="per-row"):
            tbatch.BatchGenerator(tm, num_slots=2, capacity=256,
                                  dtype=torch.float32, kv_bits=3.5)


def test_batch_cache_never_takes_k3(hd256, monkeypatch):
    """With the fused route on, a one-slot batch still decodes per linear
    (its cache is a BatchKVCache, not a KVCache), with the same tokens."""
    tm = hd256[1]
    api = _api("torch", tm)
    ref = _batch(api, PROMPTS[:1], 5, dict(num_slots=1))[0]
    lang = importlib.import_module(
        "mlx_vlm_tpu_torch.models.qwen2_vl.language")

    def refuse(*a, **k):
        raise AssertionError("K3 taken by a batch cache")

    monkeypatch.setattr(lang, "fused_decode_step", refuse)
    monkeypatch.setattr(tm.language_model, "fused_decode", True)
    got = _batch(api, PROMPTS[:1], 5, dict(num_slots=1))[0]
    _assert_same(ref, got, 0.0)


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_a_batch_block_reads_nothing_on_the_host(hd256, monkeypatch,
                                                 kv_bits):
    """A batch decode block (mixed greedy and sampled rows, per-row
    cursors) reads nothing on the host while it is dispatched."""
    tm = hd256[1]
    dispatch = tbatch._SlotBlocks.dispatch
    ran = []

    def guarded(self, n):
        with _no_host_reads():
            out = dispatch(self, n)
        ran.append(n)
        return out

    monkeypatch.setattr(tbatch._SlotBlocks, "dispatch", guarded)
    api = _api("torch", tm)
    kw = {1: dict(sampling=api.SP(temp=0.8, top_p=0.9, min_p=0.02,
                                  top_k=20))}
    out, gen = _batch(api, PROMPTS, 6, dict(kv_bits=kv_bits), kw)
    assert ran and set(ran) == {3}
    assert [len(out[u]) for u in range(3)] == [6, 6, 6]


def test_decode_state_is_rewritten_in_place(hd256):
    """Admissions and removals write into the decode step's tensors in
    place (a captured step keeps reading them): one step object, the same
    storage for the cache, cursors, tokens, history, parameters and mask
    across admissions; stats count blocks, admissions and fetches."""
    tm = hd256[1]
    api = _api("torch", tm)
    gen = tbatch.BatchGenerator(tm, num_slots=2, capacity=256, block_size=2,
                                dtype=torch.float32)
    d = gen.decode

    def storage():
        return [t.data_ptr() for t in (
            *tcache.cache_buffers(gen.cache), gen.cache.offset,
            gen.cache.left_pad, d.tok, d.history, d.deltas, d.active,
            *gen.params.values())]

    before = storage()
    for uid, p in enumerate(PROMPTS):
        gen.insert(api.Req(uid=uid, inputs_embeds=api.embeds(p),
                           max_tokens=3 + uid,
                           sampling=api.SP(temp=0.5 * uid)))
    out = _drain(gen, range(3))
    assert [len(out[u]) for u in range(3)] == [3, 4, 5]
    gen.insert(api.Req(uid=9, inputs_embeds=api.embeds(PROMPTS[0]),
                       max_tokens=6))
    gen.next()
    gen.remove(9)
    assert storage() == before and gen.decode is d
    assert not gen.active.any() and gen.num_active == 0
    assert int(gen.cache.offset.abs().sum()) == 0  # free slots parked at 0
    s = gen.stats
    assert s["captures"] == 0 and s["replays"] == 0  # eager on the CPU
    assert s["admissions"] == 3  # a batch of two, then two alone
    assert s["fetches"] == s["blocks"] + s["admissions"]
    assert s["steps"] == 2 * s["blocks"]
