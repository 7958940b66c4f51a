"""Port parity: batched speculative decoding for serving
(speculative/batch.py `SpeculativeBatchGenerator`) against the JAX
package's, both in float32 on the CPU on the same parameters
(tests/test_speculative_batch.py:86-170 on the port):

- concurrent greedy rows equal the JAX package's speculative batch and the
  port's plain `BatchGenerator`, for a drafter of another seed, a
  one-layer drafter cut from the target and the target as its own
  drafter, with `SpecStats` equal to the JAX package's; with an image
  prompt among the rows (per-row rope deltas) too;
- a late insert, a removal mid-flight, rows at mixed temperatures,
  `pop_stats` after removal, and the `input_ids` requirement;
- after every round the live rows' target and drafter cursors equal the
  JAX package's, rows capped at the capacity never write past it, and a
  round reads nothing on the host;
- the generator's state is rewritten in place across admissions (the
  captured round keeps reading the same tensors).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.generate import batch as jbatch
from mlx_vlm_tpu.speculative import batch as jsbatch
from mlx_vlm_tpu_torch.generate import batch as tbatch
from mlx_vlm_tpu_torch.generate.common import embed_prompt
from mlx_vlm_tpu_torch.speculative import batch as tsbatch
from mlx_vlm_tpu_torch.speculative import utils as tspec
from test_torch_decode_blocks import _no_host_reads
from test_torch_speculative import ckpts, tiny  # noqa: F401

torch.set_num_threads(2)

K = 3
PROMPTS = [(np.arange(9) * 5 % 200)[None], (np.arange(14) * 3 % 200)[None],
           (np.arange(5) * 11 % 200)[None]]


def _req(pkg, model, ids, uid, max_tokens=8, with_ids=True, **sampling):
    mod = jbatch if pkg == "jax" else tbatch
    if pkg == "jax":
        emb = jax.jit(model.get_input_embeddings)(model.params,
                                                  jnp.asarray(ids))
    else:
        emb = model.get_input_embeddings(
            model.params, torch.from_numpy(np.asarray(ids, np.int64)))
    return mod.BatchRequest(uid=uid, inputs_embeds=emb, max_tokens=max_tokens,
                            input_ids=np.asarray(ids) if with_ids else None,
                            sampling=mod.SamplingParams(**sampling))


def _spec(pkg, target, drafter, **kw):
    kw = dict(dict(num_draft=K, num_slots=4, capacity=256), **kw)
    if pkg == "jax":
        return jsbatch.SpeculativeBatchGenerator(target, drafter,
                                                 dtype=jnp.float32, **kw)
    return tsbatch.SpeculativeBatchGenerator(target, drafter,
                                             dtype=torch.float32, **kw)


def _drain(gen, outs, limit=200):
    for _ in range(limit):
        if not (gen.num_active or gen.queue):
            break
        for uid, toks in gen.next().items():
            outs.setdefault(uid, []).extend(t for t, _ in toks)
    return outs


def _plain(tm, prompts, max_tokens):
    gen = tbatch.BatchGenerator(tm, num_slots=4, capacity=256, block_size=2,
                                dtype=torch.float32)
    for uid, p in enumerate(prompts):
        gen.insert(_req("port", tm, p, uid, max_tokens))
    return _drain(gen, {})


def _both(tiny, drafter, prompts, max_tokens, **kw):
    """{pkg: (outputs, generator)} of the speculative batch in each
    package, every prompt inserted before the first cycle."""
    runs = {}
    for i, pkg in enumerate(("jax", "port")):
        target, draft = tiny["target"][i], tiny[drafter][i]
        gen = _spec(pkg, target, draft, **kw)
        for uid, p in enumerate(prompts):
            gen.insert(_req(pkg, target, p, uid, max_tokens))
        runs[pkg] = (_drain(gen, {}), gen)
    return runs


def _stats(st):
    return st.rounds, st.drafted, st.accepted


@pytest.mark.parametrize("drafter", ["other-seed", "one-layer", "target"])
def test_greedy_matches_jax_and_plain_batch(tiny, drafter):
    runs = _both(tiny, drafter, PROMPTS, 8)
    (jout, jgen), (tout, tgen) = runs["jax"], runs["port"]
    plain = _plain(tiny["target"][1], PROMPTS, 8)
    assert tout == jout == plain
    assert _stats(tgen.stats) == _stats(jgen.stats)
    assert tgen.stats.rounds > 0
    if drafter == "target":
        assert tgen.stats.accepted == tgen.stats.drafted
    if drafter == "one-layer":
        assert 0 < tgen.stats.accepted < tgen.stats.drafted
    st = tgen.decode.stats
    assert st["captures"] == 0 and st["replays"] == 0  # eager on the CPU
    assert st["fetches"] == st["rounds"] + st["admissions"]


def test_late_insert_and_removal(tiny):
    """A row admitted mid-flight joins the rounds without disturbing the
    row in flight; a row removed mid-flight frees its slot (both cursors
    parked at 0) and its stats stay for pop_stats, once."""
    outs = {}
    for i, pkg in enumerate(("jax", "port")):
        target, draft = tiny["target"][i], tiny["one-layer"][i]
        gen = _spec(pkg, target, draft, num_slots=2)
        gen.insert(_req(pkg, target, PROMPTS[0], 0, 12))
        gen.insert(_req(pkg, target, PROMPTS[2], 2, 12))
        got = _drain(gen, {}, limit=1)  # admit both + one round
        gen.insert(_req(pkg, target, PROMPTS[1], 1, 8))
        gen.remove(2)
        st = gen.pop_stats(2)
        assert st is not None and st.rounds == 1 and gen.pop_stats(2) is None
        outs[pkg] = (_drain(gen, got), gen)
    (jout, _), (tout, tgen) = outs["jax"], outs["port"]
    assert tout == jout
    plain = _plain(tiny["target"][1], PROMPTS[:2], 12)
    assert tout[0] == plain[0] and tout[1] == plain[1][:8]
    assert len(tout[2]) < 12
    assert tgen.d_cache.offset.tolist() == tgen.cache.offset.tolist() == [0,
                                                                          0]


def test_mixed_temperature_rows(tiny):
    """temp > 0 rows ride the walk; a greedy row in the same batch still
    equals plain greedy."""
    (_, tt), (_, td) = tiny["target"], tiny["one-layer"]
    gen = _spec("port", tt, td)
    gen.insert(_req("port", tt, PROMPTS[0], 0, 8))
    gen.insert(_req("port", tt, PROMPTS[1], 1, 8, temp=0.8, top_p=0.95))
    outs = _drain(gen, {})
    assert outs[0] == _plain(tt, [PROMPTS[0]], 8)[0]
    assert len(outs[1]) == 8 and all(0 <= t < 256 for t in outs[1])
    assert gen.uid_stats[1].drafted == K * gen.uid_stats[1].rounds


def test_requires_input_ids(tiny):
    """A request without input_ids raises before any work, in both
    packages (the reference after admitting its target row)."""
    for i, pkg in enumerate(("jax", "port")):
        target, draft = tiny["target"][i], tiny["other-seed"][i]
        gen = _spec(pkg, target, draft, num_slots=2)
        gen.insert(_req(pkg, target, PROMPTS[0], 0, 4, with_ids=False))
        with pytest.raises(ValueError, match="input_ids"):
            gen.next()
    assert gen.queue == [] and gen.num_active == 0


def test_cursors_match_jax_every_round(tiny, monkeypatch):
    """After each round the live rows' target and drafter cursors are the
    JAX package's; rows whose max_tokens the capacity caps end inside
    it (an index write past it would raise)."""
    seen = {"jax": [], "port": []}
    get_round = jsbatch.SpeculativeBatchGenerator._get_round_fn

    def recording(self):
        fn = get_round(self)

        def rnd(params, d_params, cache, d_cache, pending, pend_len, deltas,
                active, *rest):
            res = fn(params, d_params, cache, d_cache, pending, pend_len,
                     deltas, active, *rest)
            act = np.asarray(active)
            seen["jax"].append((np.asarray(res[3].offset)[act].tolist(),
                                np.asarray(res[4].offset)[act].tolist()))
            return res
        return rnd

    monkeypatch.setattr(jsbatch.SpeculativeBatchGenerator, "_get_round_fn",
                        recording)
    real = tsbatch._BatchRounds.round

    def round_(self):
        real(self)
        act = self.active.numpy()
        seen["port"].append((self.cache.offset.numpy()[act].tolist(),
                             self.d_cache.offset.numpy()[act].tolist()))

    monkeypatch.setattr(tsbatch._BatchRounds, "round", round_)
    # a long prompt whose max_tokens the capacity caps: 256 - 200 - 4 - 1
    long = (np.arange(200) * 7 % 200)[None]
    runs = _both(tiny, "target", [PROMPTS[0], long, PROMPTS[2]], 80)
    assert runs["port"][0] == runs["jax"][0]
    assert len(runs["port"][0][1]) == 256 - 200 - (K + 1) - 1
    assert seen["port"] == seen["jax"] and len(seen["port"]) > 5


def test_a_round_reads_nothing_on_the_host(tiny, monkeypatch):
    (_, tt), (_, td) = tiny["target"], tiny["one-layer"]
    ran = []
    real = tsbatch._BatchRounds.round

    def guarded(self):
        with _no_host_reads():
            real(self)
        ran.append(1)

    monkeypatch.setattr(tsbatch._BatchRounds, "round", guarded)
    gen = _spec("port", tt, td)
    gen.insert(_req("port", tt, PROMPTS[0], 0, 8, temp=0.7, top_k=20,
                    min_p=0.02))
    gen.insert(_req("port", tt, PROMPTS[1], 1, 8))
    outs = _drain(gen, {})
    assert len(outs[0]) == len(outs[1]) == 8 and len(ran) > 1


def test_state_rewritten_in_place_across_admissions(tiny):
    """The tensors a captured round reads keep their storage across
    admissions, removals and rounds."""
    (_, tt), (_, td) = tiny["target"], tiny["one-layer"]
    gen = _spec("port", tt, td, num_slots=2)
    r = gen.decode
    tensors = [r.pending, r.pend_len, r.active, r.deltas, r.result,
               gen.cache.offset, gen.d_cache.offset, gen.cache.k,
               gen.d_cache.k, *gen.params.values()]
    ptrs = [t.data_ptr() for t in tensors]
    gen.insert(_req("port", tt, PROMPTS[0], 0, 6))
    _drain(gen, {}, limit=2)
    gen.insert(_req("port", tt, PROMPTS[1], 1, 6, temp=0.5))
    gen.remove(0)
    _drain(gen, {})
    assert [t.data_ptr() for t in tensors] == ptrs
    assert gen.block >= K + 1


def _image():
    return np.random.default_rng(3).integers(0, 256, (56, 56, 3),
                                             dtype=np.uint8)


def _image_requests(pkg, model, proc):
    """An image prompt and a text prompt as BatchRequests, embedded as each
    package's batch_generate embeds them."""
    from mlx_vlm_tpu.generate.ar import embed_fn

    mod = mlx_vlm_tpu if pkg == "jax" else mlx_vlm_tpu_torch
    reqs = []
    for uid, (text, n_img) in enumerate((("What is in this image?", 1),
                                         ("Describe a cat please.", 0))):
        prompt = mod.apply_chat_template(proc, model.config_dict, text,
                                         num_images=n_img)
        inputs = mod.prepare_inputs(proc, prompt,
                                    images=[_image()] if n_img else None)
        ids = np.asarray(inputs["input_ids"])
        if pkg == "jax":
            grid = inputs.get("image_grid_thw")
            args = [jnp.asarray(ids)]
            aux = {}
            if n_img:
                args.append(jnp.asarray(inputs["pixel_values"]))
                aux = {k: jnp.asarray(v) for k, v in
                       model.vision_aux_inputs(np.asarray(grid)).items()}
            emb = embed_fn(model)(model.params, *args, **aux)
            pos, deltas = model.prepare_position_ids(
                ids, grid if n_img else None)
        else:
            emb, pos, deltas = embed_prompt(model, inputs)
        m = jbatch if pkg == "jax" else tbatch
        reqs.append(m.BatchRequest(uid=uid, inputs_embeds=emb, max_tokens=8,
                                   position_ids=pos,
                                   rope_delta=int(deltas[0, 0]),
                                   input_ids=ids))
    return reqs


def test_image_row_matches_jax(ckpts):
    """An image prompt beside a text prompt (per-row rope deltas in the
    verify) on the tiny checkpoint, the drafter of another seed."""
    outs, stats = {}, {}
    for pkg in ("jax", "port"):
        model, proc = ckpts[pkg]["target"]
        gen = _spec(pkg, model, ckpts[pkg]["other-seed"][0], num_slots=2)
        for r in _image_requests(pkg, model, proc):
            gen.insert(r)
        outs[pkg] = _drain(gen, {})
        stats[pkg] = _stats(gen.stats)
    model, proc = ckpts["port"]["target"]
    plain = tbatch.BatchGenerator(model, num_slots=2, capacity=256,
                                  block_size=2, dtype=torch.float32)
    for r in _image_requests("port", model, proc):
        plain.insert(r)
    assert outs["port"] == outs["jax"] == _drain(plain, {})
    assert stats["port"] == stats["jax"]
    assert tspec.SpecStats().acceptance_rate == 0.0
