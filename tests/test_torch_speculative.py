"""Port parity: single-stream speculative decoding with a vanilla draft
model (speculative/utils.py) against the JAX package, both in float32 on
the CPU on the same parameters:

- the rejection walk, fed the same uniforms and residual-draw noise, gives
  the `out` / `n_acc` of a numpy replay of the reference's formula
  (mlx_vlm_tpu/speculative/utils.py:164-200) and of the JAX function on
  the draws its key makes; its first committed token is distributed as
  the target's distribution (chi-square over 20,000 seeded rounds at
  V = 6, k = 3, p = 0.001); the one divergence: with u == 0 the reference
  accepts a draft whose target probability is 0, the port rejects it;
- greedy `speculative_generate_step` and `stream_generate(draft_model=)`
  give the JAX package's tokens, texts and `SpecStats` (rounds, drafted,
  accepted) for a drafter of another seed, a one-layer drafter cut from
  the target and the target as its own drafter, on a text prompt and an
  image prompt; the tokens equal the port's plain greedy decode;
- a verify never writes past the capacity, and the drafter's cursor after
  each round equals the reference's; a round reads nothing on the host;
- seeded sampling repeats; a mismatched vocabulary raises in both
  packages; `qwen2_vl_2b_config()` equals the JAX package's dict.
"""

import contextlib

import numpy as np
import pytest
import torch
from scipy import stats as scipy_stats

import jax
import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.generate.ar import generate_step as jax_plain
from mlx_vlm_tpu.generate.dispatch import stream_generate as jstream
from mlx_vlm_tpu.speculative import utils as jspec
from mlx_vlm_tpu.speculative.batch import SpeculativeBatchGenerator as JSBG
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import (build_tiny_checkpoint,
                                       make_tiny_qwen2_vl,
                                       qwen2_vl_hf_weights,
                                       tiny_qwen2_vl_config)
from mlx_vlm_tpu_torch.generate import ar as tar
from mlx_vlm_tpu_torch.generate.dispatch import generate as tgenerate
from mlx_vlm_tpu_torch.generate.dispatch import stream_generate as tstream
from mlx_vlm_tpu_torch.models.qwen2_vl import Model, ModelConfig
from mlx_vlm_tpu_torch.speculative import utils as tspec
from mlx_vlm_tpu_torch.speculative.batch import SpeculativeBatchGenerator
from mlx_vlm_tpu_torch.utils.loader import params_from_jax
from test_torch_decode_blocks import _no_host_reads

torch.set_num_threads(2)

K = 3
IDS = (np.arange(8, dtype=np.int32) * 3 % 200)[None]


def _port(jm, cfg):
    tm = Model(ModelConfig.from_dict(cfg))
    tm.params = params_from_jax(tm, jax.tree_util.tree_map(np.asarray,
                                                           jm.params))
    tm.config_dict = cfg
    tm.device = torch.device("cpu")
    return tm


def _one_layer(cfg, seed):
    """The target of `seed` cut to its first decoder layer: a drafter that
    shares its embeddings and head, so some drafts are accepted."""
    cfg1 = dict(cfg, num_hidden_layers=1)
    w = {k: v for k, v in qwen2_vl_hf_weights(cfg, seed).items()
         if not k.startswith("model.layers.1.")}
    return cfg1, jax_load(cfg1, w, jnp.float32)


@pytest.fixture(scope="module")
def tiny():
    """name -> (JAX model, port model): the target (make_tiny_qwen2_vl
    seed 0) and three drafters."""
    cfg = tiny_qwen2_vl_config()
    jt = make_tiny_qwen2_vl(seed=0, dtype=jnp.float32)
    out = {"target": (jt, _port(jt, cfg))}
    jd = make_tiny_qwen2_vl(seed=9, dtype=jnp.float32)
    out["other-seed"] = (jd, _port(jd, cfg))
    cfg1, j1 = _one_layer(cfg, 0)
    out["one-layer"] = (j1, _port(j1, cfg1))
    return out


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{"jax": {name: (model, processor)}, "port": {...}}: the tiny
    checkpoint with its trained tokenizer, and a drafter checkpoint of
    another seed, loaded by each package in float32."""
    out = {"jax": {}, "port": {}}
    for name, seed in (("target", 11), ("other-seed", 12)):
        d = tmp_path_factory.mktemp(name)
        build_tiny_checkpoint(str(d), seed=seed)
        out["jax"][name] = mlx_vlm_tpu.load(str(d), dtype=jnp.float32)
        out["port"][name] = mlx_vlm_tpu_torch.load(
            str(d), dtype=torch.float32, device="cpu")
    return out


# ------------------------------------------------------------ the walk
def _filtered(rng, B, T, V, temps):
    """Random filtered distributions [B, T, V]: softmax at each row's
    temperature, or one-hot argmax at temperature 0 (the reference's
    batched_filtered_probs)."""
    x = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    soft = np.exp(x / np.where(temps > 0, temps, 1.0)[:, None, None])
    soft /= soft.sum(-1, keepdims=True)
    onehot = np.eye(V, dtype=np.float32)[x.argmax(-1)]
    return np.where(temps[:, None, None] > 0, soft, onehot).astype(np.float32)


def _numpy_walk(pt, pd, d, u, g, strict: bool):
    """The reference's walk (utils.py:164-200) in numpy, with its draws
    given: `strict` takes the port's u * dsel < tsel in place of the
    reference's u * max(dsel, 1e-20) <= tsel."""
    B, k = d.shape
    dsel = np.take_along_axis(pd, d[..., None], -1)[..., 0]
    tsel = np.take_along_axis(pt[:, :k], d[..., None], -1)[..., 0]
    lhs = u * np.maximum(dsel, 1e-20)
    accept = lhs < tsel if strict else lhs <= tsel
    n_acc = np.argmin(np.concatenate([accept, np.zeros((B, 1), bool)], 1)
                      .astype(np.int32), axis=1)
    pt_n = pt[np.arange(B), n_acc]
    pd_pad = np.concatenate([pd, np.zeros_like(pd[:, :1])], 1)
    residual = np.maximum(pt_n - pd_pad[np.arange(B), n_acc], 0.0)
    corr = np.argmax(np.log(residual + 1e-30) + g, -1)
    idx = np.arange(k + 1)[None]
    out = np.where(idx < n_acc[:, None], np.pad(d, ((0, 0), (0, 1))), 0)
    return np.where(idx == n_acc[:, None], corr[:, None], out), n_acc


def _walk_case(seed, B=64, k=4, V=11):
    rng = np.random.default_rng(seed)
    temps = rng.choice([0.0, 0.5, 1.0, 2.0], B).astype(np.float32)
    pt = _filtered(rng, B, k + 1, V, temps)
    # a drafter near the target, so that walks end at every position
    pd = 0.5 * pt[:, :k] + 0.5 * _filtered(rng, B, k, V, temps)
    d = np.stack([[rng.choice(V, p=pd[b, i] / pd[b, i].sum())
                   for i in range(k)] for b in range(B)])
    return pt, pd.astype(np.float32), d


def _port_walk(pt, pd, d, u, g):
    out, n_acc = tspec.rejection_walk(
        torch.from_numpy(pt), torch.from_numpy(pd),
        torch.from_numpy(d.astype(np.int64)), torch.from_numpy(u),
        torch.from_numpy(g))
    return out.numpy(), n_acc.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_matches_numpy_replay_of_jax(seed):
    pt, pd, d = _walk_case(seed)
    rng = np.random.default_rng(100 + seed)
    u = rng.random(d.shape, dtype=np.float32)
    g = rng.gumbel(size=(pt.shape[0], pt.shape[-1])).astype(np.float32)
    out, n_acc = _port_walk(pt, pd, d, u, g)
    ref_out, ref_n = _numpy_walk(pt, pd, d, u, g, strict=False)
    np.testing.assert_array_equal(n_acc, ref_n)
    np.testing.assert_array_equal(out, ref_out)
    assert len(set(n_acc.tolist())) >= 3  # walks end at several positions


@pytest.mark.parametrize("seed", [0, 3])
def test_walk_matches_jax_function_on_its_draws(seed):
    """The JAX walk with a key, and the port's walk fed the uniforms and
    Gumbel noise that key's splits make (the reference's order)."""
    pt, pd, d = _walk_case(seed)
    key = jax.random.PRNGKey(seed)
    ref_out, ref_n = jspec.rejection_walk(jnp.asarray(pt), jnp.asarray(pd),
                                          jnp.asarray(d, jnp.int32), key)
    key, sub = jax.random.split(key)
    u = np.array(jax.random.uniform(sub, d.shape))
    key, sub = jax.random.split(key)
    g = np.array(jax.random.gumbel(sub, (pt.shape[0], pt.shape[-1])))
    out, n_acc = _port_walk(pt, pd, d, u, g)
    np.testing.assert_array_equal(n_acc, np.asarray(ref_n))
    np.testing.assert_array_equal(out, np.asarray(ref_out))


def test_walk_first_token_is_distributed_as_the_target():
    """20,000 seeded rounds at V = 6, k = 3 with a drafter unlike the
    target: the first committed token's frequencies against p_target."""
    n, k, V = 20000, 3, 6
    p_t = np.array([0.05, 0.3, 0.1, 0.25, 0.2, 0.1], np.float32)
    p_d = np.array([0.3, 0.05, 0.25, 0.1, 0.1, 0.2], np.float32)
    gen = torch.Generator().manual_seed(7)
    pt = torch.from_numpy(np.tile(p_t, (n, k + 1, 1)))
    pd = torch.from_numpy(np.tile(p_d, (n, k, 1)))
    d = torch.multinomial(pd.reshape(-1, V), 1, generator=gen).reshape(n, k)
    u, g = tspec.walk_noise(n, k, V, gen, "cpu")
    out, n_acc = tspec.rejection_walk(pt, pd, d, u, g)
    counts = np.bincount(out[:, 0].numpy(), minlength=V)
    res = scipy_stats.chisquare(counts, p_t / p_t.sum() * n)
    assert res.pvalue > 1e-3, (counts, res)
    # the rejection rate is 1 - sum(min(p_t, p_d)) at the first position
    rate = float((n_acc == 0).float().mean())
    assert abs(rate - (1 - np.minimum(p_t, p_d).sum())) < 0.02


def test_u_zero_divergence():
    """A draft whose target probability is 0, drawn from a one-hot draft
    distribution, with u == 0: the reference's walk (its uniform draw
    patched to return 0) accepts it, the port's rejects it."""
    V, k = 5, 2
    pt = np.zeros((1, k + 1, V), np.float32)
    pt[0, :, 1] = 1.0  # the target only ever says 1
    pd = np.zeros((1, k, V), np.float32)
    pd[0, :, 3] = 1.0  # the drafter only ever says 3
    d = np.array([[3, 3]])
    zeros = np.zeros((1, k), np.float32)
    g = np.zeros((1, V), np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jspec.jax.random, "uniform",
                   lambda key, shape, *a, **kw: jnp.zeros(shape))
        ref_out, ref_n = jspec.rejection_walk(
            jnp.asarray(pt), jnp.asarray(pd), jnp.asarray(d, jnp.int32),
            jax.random.PRNGKey(0))
    assert int(ref_n[0]) == k and list(np.asarray(ref_out)[0, :k]) == [3, 3]
    out, n_acc = _port_walk(pt, pd, d, zeros, g)
    assert int(n_acc[0]) == 0 and int(out[0, 0]) == 1
    assert _numpy_walk(pt, pd, d, zeros, g, strict=False)[1][0] == k
    assert _numpy_walk(pt, pd, d, zeros, g, strict=True)[1][0] == 0


# ------------------------------------------------------ single stream
def _jax_spec(jm, jd, ids, max_tokens, k=K, **kw):
    stats = jspec.SpecStats()
    emb = jax.jit(jm.get_input_embeddings)(jm.params, jnp.asarray(ids))
    toks = [int(t[0]) for t, _ in jspec.speculative_generate_step(
        emb, jm, jd, input_ids=ids, max_tokens=max_tokens, num_draft=k,
        stats=stats, **kw)]
    return toks, stats


def _port_spec(tm, td, ids, max_tokens, k=K, **kw):
    stats = tspec.SpecStats()
    emb = tm.get_input_embeddings(tm.params,
                                  torch.from_numpy(ids.astype(np.int64)))
    toks = [int(t[0]) for t, _ in tspec.speculative_generate_step(
        emb, tm, td, input_ids=ids, max_tokens=max_tokens, num_draft=k,
        stats=stats, **kw)]
    return toks, stats


def _same_stats(a, b) -> bool:
    return (a.rounds, a.drafted, a.accepted) == (b.rounds, b.drafted,
                                                 b.accepted)


@pytest.mark.parametrize("drafter", ["other-seed", "one-layer", "target"])
def test_greedy_speculative_matches_jax(tiny, drafter):
    """tests/test_speculative.py:256-313 on the port: greedy tokens equal
    the JAX package's and the port's plain greedy decode, SpecStats equal
    the JAX package's."""
    (jt, tt), (jd, td) = tiny["target"], tiny[drafter]
    ref, ref_stats = _jax_spec(jt, jd, IDS, 12)
    got, got_stats = _port_spec(tt, td, IDS, 12)
    emb = tt.get_input_embeddings(tt.params, torch.from_numpy(IDS.astype(
        np.int64)))
    plain = [int(t[0]) for t, _ in tar.generate_step(emb, tt, max_tokens=12)]
    jemb = jax.jit(jt.get_input_embeddings)(jt.params, jnp.asarray(IDS))
    jplain = [int(t[0]) for t, _ in jax_plain(jemb, jt, max_tokens=12)]
    assert got == ref == plain == jplain
    assert _same_stats(got_stats, ref_stats) and got_stats.rounds > 0
    if drafter == "target":  # every draft accepted
        assert got_stats.accepted == got_stats.drafted
    if drafter == "one-layer":  # some rounds accept, some reject
        assert 0 < got_stats.accepted < got_stats.drafted


class _StubTok:
    eos_token_id = 9999

    def decode(self, ids, **kw):
        return " ".join(str(i) for i in ids)

    def __call__(self, text, **kw):
        ids = [(ord(c) * 7) % 200 for c in str(text)][:12]
        return {"input_ids": np.asarray([ids]),
                "attention_mask": np.ones((1, len(ids)), np.int64)}


class _StubProc:
    tokenizer = _StubTok()

    def __call__(self, text=None, **kw):
        return self.tokenizer(text[0] if isinstance(text, list) else text)


def test_stream_generate_draft_model_lossless(tiny):
    """tests/test_speculative.py TestDispatchWiring on the port: draft_model=
    through stream_generate and generate gives the plain greedy text and
    the JAX package's; temperature > 0 runs through the walk."""
    (jt, tt), (jd, td) = tiny["target"], tiny["other-seed"]
    proc = _StubProc()
    kw = dict(max_tokens=8, temperature=0.0)
    plain = "".join(r.text for r in tstream(tt, proc, "quick brown fox",
                                            **kw))
    spec = "".join(r.text for r in tstream(tt, proc, "quick brown fox",
                                           draft_model=td,
                                           num_draft_tokens=3, **kw))
    ref = "".join(r.text for r in jstream(jt, proc, "quick brown fox",
                                          draft_model=jd, num_draft_tokens=3,
                                          **kw))
    assert spec == plain == ref
    assert tgenerate(tt, proc, "quick brown fox", draft_model=td,
                     num_draft_tokens=3, **kw).text == plain
    sampled = list(tstream(tt, proc, "x", max_tokens=4, temperature=0.5,
                           draft_model=td, seed=9))
    assert len(sampled) == 4 and all(0 <= r.token < 256 or r.text == ""
                                     for r in sampled)


@contextlib.contextmanager
def _recording_stats(records: dict):
    """Each package's speculative_generate_step handing its SpecStats to
    `records[package]` (both dispatches import it at call time)."""
    real = {"jax": jspec.speculative_generate_step,
            "port": tspec.speculative_generate_step}

    def wrap(pkg):
        def step(*a, **kw):
            records[pkg] = kw["stats"] = (jspec if pkg == "jax"
                                          else tspec).SpecStats()
            return real[pkg](*a, **kw)
        return step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jspec, "speculative_generate_step", wrap("jax"))
        mp.setattr(tspec, "speculative_generate_step", wrap("port"))
        yield


def _image():
    return np.random.default_rng(3).integers(0, 256, (56, 56, 3),
                                             dtype=np.uint8)


@pytest.mark.parametrize("drafter", ["other-seed", "target"])
@pytest.mark.parametrize("with_image", [False, True])
def test_stream_generate_matches_jax(ckpts, drafter, with_image):
    """stream_generate(draft_model=) on the tiny checkpoint with its trained
    tokenizer: tokens, text and SpecStats equal the JAX package's, the
    tokens the port's plain greedy decode; with an image prompt too (the
    verify at M-RoPE positions past the image's rope delta)."""
    runs, records = {}, {}
    for pkg, mod, stream in (("jax", mlx_vlm_tpu, jstream),
                             ("port", mlx_vlm_tpu_torch, tstream)):
        model, proc = ckpts[pkg]["target"]
        draft = ckpts[pkg][drafter][0]
        prompt = mod.apply_chat_template(
            proc, model.config_dict, "What is in this image? Describe it.",
            num_images=int(with_image))
        kw = dict(image=[_image()] if with_image else None, max_tokens=10)
        with _recording_stats(records):
            res = list(stream(model, proc, prompt, draft_model=draft,
                              num_draft_tokens=K, **kw))
        runs[pkg] = ([r.token for r in res], "".join(r.text for r in res))
        if pkg == "port":
            plain = [r.token for r in stream(model, proc, prompt, **kw)]
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == plain
    assert _same_stats(records["port"], records["jax"])
    assert records["port"].rounds > 0
    if drafter == "target" and not with_image:
        # with an image the drafter sees only the prompt's ids (the image
        # pads' text embeddings), in both packages: it drafts other tokens
        assert records["port"].acceptance_rate == 1.0


@pytest.mark.parametrize("drafter", ["other-seed", "target"])
def test_capacity_and_drafter_cursor(tiny, monkeypatch, drafter):
    """A request whose cache is exactly full: S + max_tokens + k + 2 = 256
    rows.  After every round the target's and the drafter's cursors are at
    the prompt plus the tokens emitted minus one (the reference's
    S + n - 1 + n_acc + 1), the drafter's equal to the JAX package's at
    the start of the next round, and no verify reaches past the capacity
    (an index write there would raise)."""
    (jt, tt), (jd, td) = tiny["target"], tiny[drafter]
    S, max_tokens = IDS.shape[1], 256 - IDS.shape[1] - K - 2
    seen = []
    run = tspec.SpeculativeRounds.run

    def record(self):
        before = int(self.cache.offset)
        res = run(self)
        seen.append((before, int(self.cache.offset),
                     int(self.d_cache.offset), int(res[0, K + 1]),
                     self.cache.capacity, self.d_cache.capacity))
        return res

    monkeypatch.setattr(tspec.SpeculativeRounds, "run", record)
    jax_starts = []
    draft_fn = jspec.SpeculativeEngine.draft_fn

    def recording_draft_fn(self):
        fn = draft_fn(self)

        def draft(params, cache, *a):
            jax_starts.append(int(cache.offset))
            return fn(params, cache, *a)
        return draft

    monkeypatch.setattr(jspec.SpeculativeEngine, "draft_fn",
                        recording_draft_fn)
    ref, _ = _jax_spec(jt, jd, IDS, max_tokens)
    got, _ = _port_spec(tt, td, IDS, max_tokens)
    assert got == ref and len(got) == max_tokens
    n = 1
    for i, (before, after, d_after, n_acc, cap, d_cap) in enumerate(seen):
        assert cap == d_cap == 256
        assert before == S + n - 1 and before + K < cap
        assert after == d_after == before + n_acc + 1
        if i + 1 < len(jax_starts):
            assert d_after == jax_starts[i + 1]
        n += n_acc + 1
    assert len(seen) == len(jax_starts)


def test_a_round_reads_nothing_on_the_host(tiny, monkeypatch):
    (_, tt), (_, td) = tiny["target"], tiny["one-layer"]
    rounds = []
    real = tspec.SpeculativeRounds.round

    def guarded(self):
        with _no_host_reads():
            real(self)
        rounds.append(1)

    monkeypatch.setattr(tspec.SpeculativeRounds, "round", guarded)
    toks, stats = _port_spec(tt, td, IDS, 10, temperature=0.8, top_p=0.9,
                             top_k=20, min_p=0.02, seed=3)
    assert len(toks) == 10 and len(rounds) == stats.rounds > 0


def test_seeded_sampling_repeats(tiny):
    """temperature 0.7 with a seed: the same tokens twice, every token in
    the vocabulary, the stats consistent."""
    (_, tt), (_, td) = tiny["target"], tiny["one-layer"]
    a, sa = _port_spec(tt, td, IDS, 16, temperature=0.7, seed=5)
    b, sb = _port_spec(tt, td, IDS, 16, temperature=0.7, seed=5)
    assert a == b and _same_stats(sa, sb) and len(a) == 16
    assert all(0 <= t < 256 for t in a)
    assert sa.drafted == K * sa.rounds and 0 <= sa.accepted <= sa.drafted
    assert sum(1 for _ in range(sa.rounds)) + sa.accepted >= len(a) - 1


def test_vocab_mismatch_raises_in_both_packages(tiny):
    cfg = tiny_qwen2_vl_config(vocab_size=300)
    jbad = make_tiny_qwen2_vl(seed=4, dtype=jnp.float32, config=cfg)
    tbad = _port(jbad, cfg)
    jt, tt = tiny["target"]
    with pytest.raises(ValueError, match="vocab"):
        jspec.validate_drafter_compatibility(jt, jbad)
    with pytest.raises(ValueError, match="vocab"):
        JSBG(jt, jbad, num_draft=K, num_slots=2, capacity=256,
             dtype=jnp.float32)
    with pytest.raises(ValueError, match="vocab"):
        tspec.validate_drafter_compatibility(tt, tbad)
    with pytest.raises(ValueError, match="vocab"):
        _port_spec(tt, tbad, IDS, 4)
    with pytest.raises(ValueError, match="vocab"):
        next(tstream(tt, _StubProc(), "hi", draft_model=tbad))
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeBatchGenerator(tt, tbad, num_draft=K, num_slots=2,
                                  capacity=256, dtype=torch.float32)


def test_single_stream_refusals(tiny):
    (_, tt), (_, td) = tiny["target"], tiny["other-seed"]
    emb = tt.get_input_embeddings(tt.params, torch.from_numpy(IDS.astype(
        np.int64)))
    with pytest.raises(ValueError, match="input_ids"):
        next(tspec.speculative_generate_step(emb, tt, td))
    with pytest.raises(ValueError, match="single-stream"):
        next(tspec.speculative_generate_step(emb.expand(2, -1, -1), tt, td,
                                             input_ids=IDS))
    # a target-coupled kind loads against its target (drafters/)
    with pytest.raises(ValueError, match="speculative.drafters.load_drafter"):
        tspec.load_drafter("/nonexistent", kind="eagle3")


def test_load_drafter_and_alias(tmp_path):
    """load_drafter reads a checkpoint with the port's loader; the package
    exports the JAX package's names."""
    import mlx_vlm_tpu.speculative as jpkg
    import mlx_vlm_tpu_torch.speculative as tpkg

    build_tiny_checkpoint(str(tmp_path))
    d = tspec.load_drafter(str(tmp_path), dtype=torch.float32, device="cpu")
    assert d.config_dict["vocab_size"] == 320 and d.device.type == "cpu"
    assert set(tpkg.__all__) == set(jpkg.__all__)
    assert tspec.run_speculative_rounds.__name__ == "run_speculative_rounds"


def test_qwen2_vl_2b_config_matches_jax():
    from mlx_vlm_tpu.utils import testing as jtesting
    from mlx_vlm_tpu_torch.utils import testing as ttesting

    assert ttesting.qwen2_vl_2b_config() == jtesting.qwen2_vl_2b_config()
    assert ttesting.qwen2_vl_2b_config()["vocab_size"] == 151936


def test_speculative_import_pulls_in_no_jax():
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = ("import sys, mlx_vlm_tpu_torch.speculative, "
            "mlx_vlm_tpu_torch.speculative.batch\n"
            "bad = [m for m in ('jax', 'mlx_vlm_tpu', 'triton') "
            "if m in sys.modules]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(repo),
                         env={**os.environ, "PYTHONPATH": str(repo)},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_single_stream_drafter_takes_step_logits(tiny, monkeypatch):
    """With the drafter's fused route on (an int4 drafter, its plain K3 on
    the CPU), each of a round's k drafter steps and its sync is one call of
    the drafter's `step_logits` taking the whole-stack step, as the
    reference's `lm(...)` at B = 1 takes its fused step; the tokens and
    SpecStats equal the JAX package's (whose drafter runs its fused step)
    and the same drafter's on the per-linear route."""
    from mlx_vlm_tpu_torch.models.qwen2_vl import language as language_mod
    from mlx_vlm_tpu_torch.utils.loader import decide_fused_decode
    from test_torch_fused_decode import _models

    jt, tt = tiny["target"]
    jd, td, _ = _models(2, seed=13)
    assert "fused_decode" in jd.params["language_model"]
    assert decide_fused_decode(td)
    fused, steps = [], []
    step = language_mod.fused_decode_step
    monkeypatch.setattr(language_mod, "fused_decode_step",
                        lambda *a: fused.append(1) or step(*a))
    real = td.language_model.step_logits
    monkeypatch.setattr(td.language_model, "step_logits",
                        lambda *a: steps.append(a[1].shape) or real(*a))
    ref, ref_stats = _jax_spec(jt, jd, IDS, 12)
    got, got_stats = _port_spec(tt, td, IDS, 12)
    n_fused = len(fused)
    td.language_model.fused_decode = False
    try:
        plain, plain_stats = _port_spec(tt, td, IDS, 12)
    finally:
        td.language_model.fused_decode = True
    assert got == ref == plain
    assert _same_stats(got_stats, ref_stats) and _same_stats(got_stats,
                                                            plain_stats)
    assert n_fused == got_stats.rounds * (K + 1) > 0
    assert len(fused) == n_fused  # the per-linear run took no fused step
    assert len(steps) == 2 * n_fused and set(steps) == {(1, 1, 128)}
