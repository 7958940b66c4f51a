"""Port parity: the EAGLE-3 and MTP drafters (speculative/drafters/
eagle3.py, mtp.py, the registry and loader in drafters/__init__.py),
`eagle3_generate_step` (speculative/utils.py) and the llama decoder's
`forward_masked`, against the JAX package on the CPU, both in float32 on
the same weights: the JAX package's tiny 3-layer llama target
(tests/test_speculative.py's) and its test drafters, drawn from the same
seeds with numpy in both packages.

- the random-parameter builders: the same arrays;
- the first round's draft tokens and the committed streams, token for
  token (and both equal to the target's plain greedy decode), with equal
  `SpecStats`; and the all-accepted case (the final norms of target and
  drafter zeroed: every logit row is 0, both argmax to token 0), where
  every round accepts k - 1 drafts, the JAX package's cap;
- `resolve_drafter_kind` exactly; `load_drafter` from checkpoint
  directories written in tmp_path, in both packages, with the shared
  embedding and head bound to the target;
- `forward_masked`'s logits within 1e-4 (the f32 CPU tolerance of
  tests/test_torch_llama.py) under a tree's ancestor mask;
- a quantized (exact, 4-bit) target: the port's drafter takes the rows
  and head through the target's `embed` / `logits`, where the JAX
  package's `_step` takes the shared table's `weight` and fails.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.generate.ar import generate_step as jax_generate_step
from mlx_vlm_tpu.speculative import drafters as jdr
from mlx_vlm_tpu.speculative import utils as jsu
from mlx_vlm_tpu.speculative.drafters import eagle3 as je3
from mlx_vlm_tpu.speculative.drafters import mtp as jmtp
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu_torch.core import cache as cache_lib
from mlx_vlm_tpu_torch.generate.ar import generate_step
from mlx_vlm_tpu_torch.speculative import drafters as tdr
from mlx_vlm_tpu_torch.speculative import utils as tsu
from mlx_vlm_tpu_torch.speculative.drafters import eagle3 as te3
from mlx_vlm_tpu_torch.speculative.drafters import mtp as tmtp
from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
from mlx_vlm_tpu_torch.utils.testing import (llama_hf_weights,
                                             mlx_int4_checkpoint,
                                             tiny_drafter_configs,
                                             tiny_llama_config,
                                             write_drafter_checkpoint)
from test_torch_qwen2_5_vl import jax_leaf

torch.set_num_threads(2)

TOL = 1e-4
PROMPTS = {"a": (np.arange(9) * 5 % 200)[None],
           "b": (np.arange(6) + 3)[None]}
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads",
          "num_key_value_heads", "vocab_size")


def _targets(zero_norm: bool = False) -> tuple:
    cfg = tiny_llama_config(num_hidden_layers=3)
    w = llama_hf_weights(cfg, seed=1)
    if zero_norm:
        w["model.norm.weight"] = np.zeros_like(w["model.norm.weight"])
    return (cfg, jax_load(cfg, w, jnp.float32),
            load_model_from_weights(cfg, w, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def targets():
    return _targets()


def _embeds(jm, tm, ids) -> tuple:
    ids = np.asarray(ids, np.int32)
    return (jax.jit(jm.get_input_embeddings)(jm.params, jnp.asarray(ids)),
            tm.get_input_embeddings(tm.params,
                                    torch.from_numpy(ids).long()))


def _np(tree):
    """A port parameter tree as numpy (for the JAX package)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _drafters(cfg: dict, kind: str, seed: int, shared=None) -> tuple:
    """(JAX drafter, its params, port drafter, its params) of `kind` at
    the target's widths, from one seed; MTP with the target's table as
    its embedding and head when `shared` is (JAX table, port table)."""
    c = tiny_drafter_configs(cfg)[kind]
    w = {k: c[k] for k in WIDTHS}
    if kind == "eagle3":
        jd = je3.Eagle3Drafter(je3.Eagle3Config(
            **w, capture_layers=tuple(c["capture_layers"])))
        td = te3.Eagle3Drafter(te3.Eagle3Config(
            **w, capture_layers=tuple(c["capture_layers"])))
        return (jd, je3.init_eagle3_params(jd.config, seed=seed), td,
                te3.init_eagle3_params(td.config, seed=seed))
    jd, td = jmtp.MTPDrafter(jmtp.MTPConfig(**w)), tmtp.MTPDrafter(
        tmtp.MTPConfig(**w))
    js = dict(shared_embed=shared[0], shared_lm_head=shared[0]) \
        if shared else {}
    ts = dict(shared_embed=shared[1], shared_lm_head=shared[1]) \
        if shared else {}
    return (jd, jmtp.init_mtp_params(jd.config, seed=seed, **js), td,
            tmtp.init_mtp_params(td.config, seed=seed, **ts))


def _tables(jm, tm) -> tuple:
    return (jm.params["language_model"]["model"]["embed_tokens"]["weight"],
            tm.params["language_model"]["model"]["embed_tokens"]["weight"])


def _stream(step, *args, **kw) -> list:
    return [int(t[0]) for t, _ in step(*args, **kw)]


def _plain(jm, je, n) -> list:
    return [int(t[0]) for t, _ in jax_generate_step(je, jm, max_tokens=n)]


@pytest.mark.parametrize("kind,seed", [("eagle3", 3), ("mtp", 5),
                                       ("mtp_own_table", 2)])
def test_init_params_equal_jax(targets, kind, seed):
    cfg, jm, tm = targets
    shared = None if kind != "mtp" else _tables(jm, tm)
    _, jp, _, tp = _drafters(cfg, kind.split("_")[0], seed, shared)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(_np(tp)))
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        assert np.array_equal(np.asarray(leaf), node.numpy()), path


@pytest.mark.parametrize("kind", ["eagle3", "mtp"])
@pytest.mark.parametrize("prompt", list(PROMPTS))
@pytest.mark.parametrize("k", [3, 4])
def test_stream_matches_jax(targets, kind, prompt, k):
    """The committed streams of both packages, the target's plain greedy
    decode and equal SpecStats (MTP with the target's table shared, as
    tests/test_speculative.py:237-240 builds it)."""
    cfg, jm, tm = targets
    jd, jp, td, tp = _drafters(cfg, kind, 3 if kind == "eagle3" else 5,
                               _tables(jm, tm) if kind == "mtp" else None)
    je, te = _embeds(jm, tm, PROMPTS[prompt])
    js, ts = jsu.SpecStats(), tsu.SpecStats()
    ref = _stream(jsu.eagle3_generate_step, je, jm, jd, jp, max_tokens=12,
                  num_draft=k, stats=js)
    got = _stream(tsu.eagle3_generate_step, te, tm, td, tp, max_tokens=12,
                  num_draft=k, stats=ts)
    assert got == ref == _plain(jm, je, 12)
    assert (ts.rounds, ts.drafted, ts.accepted) == (js.rounds, js.drafted,
                                                    js.accepted)
    assert tsu.last_rounds.stats["rounds"] == ts.rounds


@pytest.mark.parametrize("kind", ["eagle3", "mtp"])
def test_first_round_draft_tokens_match_jax(targets, kind):
    """The drafter's k tokens from the prompt's capture: the target's
    prefill through forward_captured, the fused feature at the last
    position, k greedy steps from the first token."""
    cfg, jm, tm = targets
    jd, jp, td, tp = _drafters(cfg, kind, 7)
    je, te = _embeds(jm, tm, PROMPTS["a"])
    S, k = je.shape[1], 4
    jlm, jlp = jm.language_model, jm.params["language_model"]
    jcache = jlm.init_cache(1, 64, jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (3, 1, S))
    jh, _, jhid = jlm.forward_captured(jlp, je, jcache, pos)
    jtok = jnp.argmax(jlm.logits(jlp, jh)[:, -1], -1).astype(jnp.int32)
    jfeat = jd.fuse_features(jp, jhid)[:, -1]
    jtoks, _ = jd.draft_fn(k)(jp, jd.init_cache(1, 64), jtok, jfeat,
                              jnp.asarray(0, jnp.int32))
    tlm, tlp = tm.language_model, tm.params["language_model"]
    tcache = tlm.init_cache(1, 64, torch.float32)
    logits, thid = tsu.captured_prefill(tlm, tlp, te, tcache)
    ttok = torch.argmax(logits, -1)
    tfeat = td.fuse_features(tp, thid)[:, -1]
    d_cache = td.init_cache(1, 64)
    ttoks = td.draft_fn(k)(tp, d_cache, ttok, tfeat,
                           torch.zeros((), dtype=torch.int32))
    assert int(jtok[0]) == int(ttok[0])
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), rtol=0,
                               atol=TOL)
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    assert int(d_cache.offset) == k


@pytest.mark.parametrize("kind", ["eagle3", "mtp"])
def test_all_accepted(kind):
    """Final norms of target and drafter zeroed: every logit row is 0, the
    drafts and the target's greedy tokens are all 0, and every round
    accepts k - 1 drafts (the cap) in both packages."""
    cfg, jm, tm = _targets(zero_norm=True)
    jd, jp, td, tp = _drafters(cfg, kind, 3)
    jp = dict(jp, norm={"weight": jnp.zeros_like(jp["norm"]["weight"])})
    tp["norm"]["weight"].zero_()
    je, te = _embeds(jm, tm, PROMPTS["a"])
    js, ts = jsu.SpecStats(), tsu.SpecStats()
    k = 4
    ref = _stream(jsu.eagle3_generate_step, je, jm, jd, jp, max_tokens=16,
                  num_draft=k, stats=js)
    got = _stream(tsu.eagle3_generate_step, te, tm, td, tp, max_tokens=16,
                  num_draft=k, stats=ts)
    assert got == ref == [0] * 16
    assert ts.accepted == (k - 1) * ts.rounds > 0
    assert (ts.rounds, ts.drafted, ts.accepted) == (js.rounds, js.drafted,
                                                    js.accepted)
    # the target's cursor: the prompt and every committed token but the
    # last, whose K/V the next round writes
    rounds = tsu.last_rounds
    assert int(rounds.cache.offset) == PROMPTS["a"].shape[1] + k * ts.rounds
    assert int(rounds.d_cache.offset) == k * ts.rounds


@pytest.mark.parametrize("model_type", [
    "eagle3", "qwen3_5_mtp", "deepseek_v4_mtp", "gemma4_assistant",
    "qwen3_dflash", "qwen3_5_dflash", "my_dflash_v2", "x_mtp", "llama",
    "qwen2_vl", ""])
def test_resolve_drafter_kind_matches_jax(model_type):
    assert (tdr.resolve_drafter_kind(model_type)
            == jdr.resolve_drafter_kind(model_type))
    assert tdr.DRAFTER_KIND_BY_MODEL_TYPE == jdr.DRAFTER_KIND_BY_MODEL_TYPE


@pytest.mark.parametrize("kind", ["eagle3", "mtp", "dflash"])
def test_load_drafter_from_checkpoint(targets, tmp_path, kind):
    """A drafter directory (port writer, embedding and head omitted)
    loaded by both packages: the same kind and config, the target bound
    for the omitted tables, and the same stream, the plain greedy one."""
    from mlx_vlm_tpu.speculative.dflash import dflash_generate_step as jdf
    from mlx_vlm_tpu_torch.speculative.dflash import \
        dflash_generate_step as tdf
    from mlx_vlm_tpu_torch.speculative.drafters.dflash import \
        init_dflash_params

    cfg, jm, tm = targets
    c = tiny_drafter_configs(cfg)[kind]
    if kind == "dflash":
        params = init_dflash_params(tdr.DFlashConfig(
            **{k: c[k] for k in WIDTHS}, num_hidden_layers=2,
            target_layer_ids=(0, 2)), seed=4)
    else:
        _, _, _, params = _drafters(cfg, kind, 4)
    write_drafter_checkpoint(tmp_path, c, params)
    jd, jp, jkind = jdr.load_drafter(tmp_path, jm)
    td, tp, tkind = tdr.load_drafter(tmp_path, tm, device="cpu")
    assert tkind == jkind == kind
    assert td.config == type(td.config)(**vars(jd.config))
    assert "embed_tokens" not in tp and "lm_head" not in tp
    if kind != "dflash":
        assert td.target[0] is tm.language_model
    je, te = _embeds(jm, tm, PROMPTS["a"])
    if kind == "dflash":
        assert tp["layers"]["self_attn"]["q_proj"]["weight"].shape[0] == 2
        ref = _stream(jdf, je, jm, jd, jp, max_tokens=10)
        got = _stream(tdf, te, tm, td, tp, max_tokens=10)
    else:
        ref = _stream(jsu.eagle3_generate_step, je, jm, jd, jp,
                      max_tokens=10, num_draft=3)
        got = _stream(tsu.eagle3_generate_step, te, tm, td, tp,
                      max_tokens=10, num_draft=3)
    assert got == ref == _plain(jm, je, 10)


def test_load_drafter_refuses_what_the_reference_refuses(targets, tmp_path):
    _, jm, tm = targets
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "qwen3_5_mtp", "hidden_size": 9999}))
    for load, m in ((jdr.load_drafter, jm),
                    (lambda p, t: tdr.load_drafter(p, t, device="cpu"),
                     tm)):
        with pytest.raises(ValueError, match="hidden_size"):
            load(tmp_path, m)
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "llama"}))
    with pytest.raises(ValueError, match="unknown drafter"):
        tdr.load_drafter(tmp_path, tm, device="cpu")


@pytest.mark.parametrize("kind", ["eagle3", "mtp", "dflash"])
def test_vanilla_loader_names_the_coupled_loader(kind):
    """Kept divergence: the vanilla `load_drafter` (speculative/utils.py)
    refuses a target-coupled kind, naming the loader that takes it; the
    reference's ignores `kind` (speculative/utils.py:142)."""
    with pytest.raises(ValueError, match="speculative.drafters.load_drafter"):
        tsu.load_drafter("unused", kind=kind, device="cpu")


def _tree_mask(n: int, seed: int) -> np.ndarray:
    """A random tree's ancestor mask over [root | n nodes]."""
    rng = np.random.default_rng(seed)
    parent = [-1] + [int(rng.integers(-1, i)) for i in range(1, n)]
    m = np.eye(n + 1, dtype=bool)
    m[:, 0] = True
    for i in range(n):
        j = parent[i]
        while j != -1:
            m[i + 1, j + 1] = True
            j = parent[j]
    return m


@pytest.mark.parametrize("offset,n", [(9, 6), (20, 8), (0, 3)])
def test_forward_masked_matches_jax(targets, offset, n):
    """The S = n + 1 new rows over a cache of `offset` written rows and a
    tree mask among them: logits within 1e-4; the cache untouched."""
    cfg, jm, tm = targets
    rng = np.random.default_rng(offset + n)
    hist = rng.integers(0, 256, (1, max(offset, 1)))
    seq = rng.integers(0, 256, (1, n + 1))
    depths = np.concatenate([[0], rng.integers(1, 4, n)])
    amask = _tree_mask(n, offset)
    jlm, jlp = jm.language_model, jm.params["language_model"]
    tlm, tlp = tm.language_model, tm.params["language_model"]
    jcache = jlm.init_cache(1, 64, jnp.float32)
    tcache = tlm.init_cache(1, 64, torch.float32)
    if offset:
        he, ht = _embeds(jm, tm, hist)
        pos = jnp.broadcast_to(jnp.arange(offset, dtype=jnp.int32),
                               (3, 1, offset))
        _, jcache = jlm(jlp, he, jcache, pos)
        tlm(tlp, ht, tcache, torch.arange(offset)[None])
    se, st = _embeds(jm, tm, seq)
    jpos = jnp.broadcast_to(jnp.asarray(offset + depths, jnp.int32)[None,
                                                                      None],
                            (3, 1, n + 1))
    jh, _ = jlm.forward_masked(jlp, se, jcache, jpos, jnp.asarray(amask))
    k_before = tcache.k.clone()
    th = tlm.forward_masked(tlp, st, tcache,
                            torch.from_numpy(offset + depths)[None],
                            torch.from_numpy(amask))
    np.testing.assert_allclose(tlm.logits(tlp, th).numpy(),
                               np.asarray(jlm.logits(jlp, jh)), rtol=0,
                               atol=TOL)
    assert torch.equal(tcache.k, k_before) and int(tcache.offset) == offset


def test_forward_masked_refuses_other_caches(targets):
    from mlx_vlm_tpu_torch.generate.ar import make_cache

    _, _, tm = targets
    lm, lp = tm.language_model, tm.params["language_model"]
    cache = make_cache(tm, 1, 256, torch.float32, kv_bits=4, device="cpu")
    with pytest.raises(TypeError, match="KVCache"):
        lm.forward_masked(lp, torch.zeros((1, 2, 64)), cache,
                          torch.zeros((1, 2), dtype=torch.long),
                          torch.ones((2, 2), dtype=torch.bool))
    assert isinstance(lm.init_cache(1, 8), cache_lib.KVCache)


@pytest.mark.parametrize("kind", ["eagle3", "mtp"])
def test_quantized_target_shares_its_table(tmp_path, kind, monkeypatch):
    """Reference fault (speculative/drafters/eagle3.py:73, mtp.py:72): the
    drafter takes the shared embedding by `jnp.take` of the table's
    `weight`, which an exact (mlx group-affine) target holds as packed
    codes, so a drafter that shares a quantized target's table fails.
    The port's bound drafter takes rows through the target's `embed` (the
    dequantized rows) and the head through its `logits`: its stream is
    the quantized target's plain greedy decode."""
    monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", "exact")
    cfg, w = mlx_int4_checkpoint(tiny_llama_config(num_hidden_layers=3),
                                 seed=6, group_size=32)
    jm = jax_load(dict(cfg), {k: jax_leaf(v) for k, v in w.items()},
                  jnp.float32)
    tm = load_model_from_weights(cfg, w, torch.float32, "cpu")
    table = tm.params["language_model"]["model"]["embed_tokens"]["weight"]
    assert type(table).__name__ == "QuantizedTensor"
    c = tiny_drafter_configs(cfg)[kind]
    _, _, _, params = _drafters(cfg, kind, 4)
    write_drafter_checkpoint(tmp_path, c, params)
    td, tp, _ = tdr.load_drafter(tmp_path, tm, device="cpu")
    ids = PROMPTS["a"]
    te = tm.get_input_embeddings(tm.params, torch.from_numpy(ids).long())
    plain = [int(t[0]) for t, _ in generate_step(te, tm, max_tokens=10)]
    got = _stream(tsu.eagle3_generate_step, te, tm, td, tp, max_tokens=10,
                  num_draft=3)
    assert got == plain
    tok = torch.tensor([7, 99])
    assert torch.equal(td.embed(tp, tok),
                       tm.language_model.embed(tm.params["language_model"],
                                               tok))
    jd, jp, _ = jdr.load_drafter(tmp_path, jm)
    je = jax.jit(jm.get_input_embeddings)(jm.params, jnp.asarray(ids))
    with pytest.raises(Exception):
        _stream(jsu.eagle3_generate_step, je, jm, jd, jp, max_tokens=10,
                num_draft=3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["eagle3", "mtp"])
def test_captured_rounds_equal_eager_on_the_card(kind):
    """On a card each round after the first replays the captured one:
    the stream and both caches bit-identical to every round eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    cfg = tiny_llama_config(num_hidden_layers=3)
    tm = load_model_from_weights(cfg, llama_hf_weights(cfg, seed=1),
                                 torch.bfloat16, "cuda")
    _, _, td, tp = _drafters(cfg, kind, 3)
    tp = jax.tree_util.tree_map(lambda t: t.to("cuda", torch.bfloat16), tp)
    ids = torch.from_numpy(PROMPTS["a"]).long().cuda()
    te = tm.get_input_embeddings(tm.params, ids)
    runs = []
    for graph in (True, False):
        real = tsu.Eagle3Rounds.__init__

        def init(self, *a, **kw):
            real(self, *a, **kw)
            self.use_graph = graph

        tsu.Eagle3Rounds.__init__ = init
        try:
            toks = _stream(tsu.eagle3_generate_step, te, tm, td, tp,
                           max_tokens=24, num_draft=4)
        finally:
            tsu.Eagle3Rounds.__init__ = real
        r = tsu.last_rounds
        runs.append((toks, r.cache.k.clone(), r.d_cache.k.clone(),
                     r.stats["replays"]))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
    assert runs[0][3] > 0 and runs[1][3] == 0
