"""Port parity: the DFlash drafter (speculative/drafters/dflash.py), its
round loop (speculative/dflash.py) and DDTree's tree verify
(speculative/ddtree.py) against the JAX package on the CPU, both in
float32 on the same weights: the JAX package's tiny 3-layer llama target
and its test DFlash drafter (2 layers, block 4, target layers 0 and 2,
mask token 5; tests/test_dflash.py's), drawn from the same seeds.

- `init_dflash_params`: the same arrays; the block's draft tokens exactly
  and its draft logits within 1e-4 (the f32 CPU tolerance of
  tests/test_torch_llama.py); an append past the valid count overwritten
  by the next, as in the reference;
- `next_block_size` on seeded acceptance histories, `build_ddtree`,
  `tree_ancestor_mask` and `walk_tree` on seeded logits: exactly equal;
- `dflash_generate_step` (adaptive and fixed blocks) and
  `tree_generate_step`: the committed streams token for token, equal to
  the target's plain greedy decode, with equal stats; and the
  all-accepted case (final norms of target and drafter zeroed), where
  every DFlash round commits its whole block and every tree its deepest
  path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.speculative import ddtree as jdt
from mlx_vlm_tpu.speculative import dflash as jdf
from mlx_vlm_tpu.speculative.drafters import dflash as jdd
from mlx_vlm_tpu_torch.speculative import ddtree as tdt
from mlx_vlm_tpu_torch.speculative import dflash as tdf
from mlx_vlm_tpu_torch.speculative.drafters import dflash as tdd
from test_torch_drafters import PROMPTS, TOL, _embeds, _plain, _targets

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def targets():
    return _targets()


def _dflash(cfg: dict, seed: int = 3) -> tuple:
    """(JAX drafter, its params, port drafter, its params):
    tests/test_dflash.py's `_tiny_dflash`."""
    fields = dict(hidden_size=cfg["hidden_size"],
                  intermediate_size=cfg["intermediate_size"],
                  num_attention_heads=cfg["num_attention_heads"],
                  num_key_value_heads=cfg["num_key_value_heads"],
                  vocab_size=cfg["vocab_size"], num_hidden_layers=2,
                  mask_token_id=5, block_size=4, target_layer_ids=(0, 2),
                  target_hidden_size=cfg["hidden_size"])
    jd = jdd.DFlashDrafter(jdd.DFlashConfig(**fields))
    td = tdd.DFlashDrafter(tdd.DFlashConfig(**fields))
    return (jd, jdd.init_dflash_params(jd.config, seed=seed), td,
            tdd.init_dflash_params(td.config, seed=seed))


def test_init_params_equal_jax(targets):
    cfg, _, _ = targets
    _, jp, _, tp = _dflash(cfg, seed=11)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for p in path:
            node = node[p.key]
        assert np.array_equal(np.asarray(leaf), node.numpy()), path


@pytest.mark.parametrize("bs", [2, 4, 6])
def test_block_draft_matches_jax(targets, bs):
    """A context of 3 random rows appended, then the block from a bonus:
    the draft tokens exactly, the draft logits within 1e-4."""
    cfg, jm, tm = targets
    jd, jp, td, tp = _dflash(cfg)
    ctx = np.random.default_rng(bs).standard_normal(
        (1, 3, 2 * cfg["hidden_size"])).astype(np.float32)
    jc = jd.append_fn(3)(jp, jd.init_cache(1, 32), jnp.asarray(ctx),
                         jnp.asarray(3, jnp.int32))
    tc = td.init_cache(1, 32)
    td.append_fn(3)(tp, tc, torch.from_numpy(ctx), 3)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0,
                               atol=TOL)
    ref = jd.draft_fn(jm.language_model, bs)(jm.params, jp, jc,
                                             jnp.asarray([7], jnp.int32))
    got = td.draft_fn(tm.language_model, bs)(tm.params, tp, tc,
                                             torch.tensor([7]))
    assert got.shape == (1, bs - 1)
    assert got.tolist() == np.asarray(ref).tolist()
    rl = jd.draft_logits_fn(jm.language_model, bs)(
        jm.params, jp, jc, jnp.asarray([7], jnp.int32))
    gl = td.draft_logits_fn(tm.language_model, bs)(tm.params, tp, tc,
                                                   torch.tensor([7]))
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), rtol=0, atol=TOL)
    assert int(tc.offset) == 3  # the draft reads the cache only


def test_append_past_the_valid_count_is_overwritten(targets):
    """4 rows appended with 2 valid, then 2 more: the cache's first 4 rows
    as if the 2 valid and the 2 new had been appended at once (the
    reference's test_append_rollback_overwrites), and as the reference's
    own state."""
    cfg, _, _ = targets
    jd, jp, td, tp = _dflash(cfg)
    rng = np.random.default_rng(0)
    D2 = 2 * cfg["hidden_size"]
    a = rng.standard_normal((1, 4, D2)).astype(np.float32)
    b = rng.standard_normal((1, 2, D2)).astype(np.float32)
    c1 = td.init_cache(1, 16)
    td.append_fn(4)(tp, c1, torch.from_numpy(a), torch.tensor(2))
    td.append_fn(2)(tp, c1, torch.from_numpy(b), 2)
    c2 = td.init_cache(1, 16)
    td.append_fn(4)(tp, c2, torch.from_numpy(np.concatenate([a[:, :2], b],
                                                            axis=1)), 4)
    np.testing.assert_allclose(c1.k[:, :, :, :4].numpy(),
                               c2.k[:, :, :, :4].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(c1.offset) == int(c2.offset) == 4
    jc = jd.append_fn(4)(jp, jd.init_cache(1, 16), jnp.asarray(a),
                         jnp.asarray(2, jnp.int32))
    jc = jd.append_fn(2)(jp, jc, jnp.asarray(b), jnp.asarray(2, jnp.int32))
    np.testing.assert_allclose(c1.k.numpy(), np.asarray(jc.k), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("seed", range(6))
def test_next_block_size_matches_jax(seed):
    rng = np.random.default_rng(seed)
    js, ts = jdf.DFlashStats(), tdf.DFlashStats()
    for _ in range(int(rng.integers(0, 20))):
        d = int(rng.integers(1, 16))
        a = int(rng.integers(0, d + 1))
        js.record(a, d)
        ts.record(a, d)
    for ceiling in (4, 8, 16):
        for remaining in (1, 2, 3, 5, 9, 100):
            assert (tdd.next_block_size(ts, ceiling, remaining)
                    == jdd.next_block_size(js, ceiling, remaining))
    assert ts.recent == js.recent
    assert (ts.rounds, ts.drafted, ts.accepted) == (js.rounds, js.drafted,
                                                    js.accepted)


@pytest.mark.parametrize("seed,L,V,budget", [(0, 3, 10, 6), (1, 2, 6, 4),
                                             (2, 5, 40, 12), (3, 1, 5, 9),
                                             (4, 4, 3, 30)])
def test_tree_host_code_matches_jax(seed, L, V, budget):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((L, V)).astype(np.float32)
    ref = jdt.build_ddtree(logits, budget)
    got = tdt.build_ddtree(logits, budget)
    assert [vars(n) for n in got] == [vars(n) for n in ref]
    assert np.array_equal(tdt.tree_ancestor_mask(got),
                          jdt.tree_ancestor_mask(ref))
    for _ in range(5):
        greedy = rng.integers(0, V, len(got) + 1)
        greedy[0] = got[0].token_ids[-1] if rng.random() < 0.7 else greedy[0]
        assert tdt.walk_tree(got, greedy) == jdt.walk_tree(ref, greedy)
    assert tdt.build_ddtree(logits[None], budget, slot_offset=1) == [
        tdt.DDTreeNode(**vars(n))
        for n in jdt.build_ddtree(logits[None], budget, slot_offset=1)]


@pytest.mark.parametrize("prompt", list(PROMPTS))
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("seed", [3, 11])
def test_dflash_stream_matches_jax(targets, prompt, adaptive, seed):
    cfg, jm, tm = targets
    jd, jp, td, tp = _dflash(cfg, seed)
    je, te = _embeds(jm, tm, PROMPTS[prompt])
    js, ts = jdf.DFlashStats(), tdf.DFlashStats()
    ref = [int(t[0]) for t, _ in jdf.dflash_generate_step(
        je, jm, jd, jp, max_tokens=12, adaptive=adaptive, stats=js)]
    got = [int(t[0]) for t, _ in tdf.dflash_generate_step(
        te, tm, td, tp, max_tokens=12, adaptive=adaptive, stats=ts)]
    assert got == ref == _plain(jm, je, 12)
    assert ts.recent == js.recent


@pytest.mark.parametrize("prompt", list(PROMPTS))
@pytest.mark.parametrize("budget", [3, 6])
def test_tree_stream_matches_jax(targets, prompt, budget):
    cfg, jm, tm = targets
    jd, jp, td, tp = _dflash(cfg)
    je, te = _embeds(jm, tm, PROMPTS[prompt])
    js, ts = jdf.DFlashStats(), tdf.DFlashStats()
    ref = [int(t[0]) for t, _ in jdt.tree_generate_step(
        je, jm, jd, jp, max_tokens=12, tree_budget=budget, stats=js)]
    got = [int(t[0]) for t, _ in tdt.tree_generate_step(
        te, tm, td, tp, max_tokens=12, tree_budget=budget, stats=ts)]
    assert got == ref == _plain(jm, je, 12)
    assert ts.recent == js.recent
    assert set(tdt.last_rounds) == {budget + 1}


@pytest.mark.parametrize("tree", [False, True])
def test_all_accepted(tree):
    """Final norms zeroed: every draft and greedy token is 0; DFlash
    commits each block whole (k drafts and the bonus), DDTree the deepest
    path (depth bs - 1); the same stream and stats as the JAX package."""
    cfg, jm, tm = _targets(zero_norm=True)
    jd, jp, td, tp = _dflash(cfg)
    jp = dict(jp, norm={"weight": jnp.zeros_like(jp["norm"]["weight"])})
    tp["norm"]["weight"].zero_()
    je, te = _embeds(jm, tm, PROMPTS["a"])
    js, ts = jdf.DFlashStats(), tdf.DFlashStats()
    jstep, tstep = ((jdt.tree_generate_step, tdt.tree_generate_step)
                    if tree else (jdf.dflash_generate_step,
                                  tdf.dflash_generate_step))
    ref = [int(t[0]) for t, _ in jstep(je, jm, jd, jp, max_tokens=16,
                                       stats=js)]
    got = [int(t[0]) for t, _ in tstep(te, tm, td, tp, max_tokens=16,
                                       stats=ts)]
    assert got == ref == [0] * 16
    assert ts.recent == js.recent
    # DFlash: every block whole; DDTree: the tree of 0-logits (ties broken
    # by the heap's order) walked along its token-0 path
    full = 3
    if tree:
        nodes = tdt.build_ddtree(np.zeros((3, cfg["vocab_size"])), 8)
        full = len(tdt.walk_tree(nodes, np.zeros(len(nodes) + 1, int)))
    assert full > 0
    assert all(a == full and d == 3 for a, d in ts.recent)
