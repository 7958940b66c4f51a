"""Port parity: the llama family (models/llama, models/text_only) against
the JAX package, both in float32 on the CPU on the same weights, at the
JAX package's test size (hidden 64, 2 decoder layers, 4 / 2 heads):

- host layouts exactly: the published Llama-3.1-8B config, the weight
  builder, `sanitize`, `text_position_ids`, the loader's model-type
  dispatch (llama, mistral, qwen2 and qwen3 through the text-only
  fallback or the remapping, llava and llava_next; gemma and gemma2
  through the fallback on PaliGemma's decoder);
- the language model for llama, mistral, qwen2 (q / k / v biases), qwen3
  (per-head q / k norms) and a partial-rotary llama3-scaled variant:
  cached prefill and decode steps, the uncached call and
  `forward_captured`'s per-layer hiddens within 1e-4;
- a random 4-bit mlx checkpoint through both loaders: w8chan by default
  (the route off), exact or w4grp on request, the same parameters and
  logits;
- greedy `generate`, `batch_generate` and one served chat on a tiny
  checkpoint on disk, token for token as the JAX package's (both take the
  port's processor over a byte tokenizer, so no transformers loads).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.models.llama import Model as JaxModel
from mlx_vlm_tpu.models.llama.llama import \
    text_position_ids as jax_text_position_ids
from mlx_vlm_tpu.utils.loader import get_model_and_args as jax_model_and_args
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import llama_hf_weights as jax_hf_weights
from mlx_vlm_tpu.utils.testing import tiny_llama_config as jax_tiny_config
from mlx_vlm_tpu_torch.core.quant import (ChannelQuantizedTensor,
                                          Int4GroupedTensor, QuantizedTensor)
from mlx_vlm_tpu_torch.models.llama import Model, TextConfig
from mlx_vlm_tpu_torch.models.llama.llama import text_position_ids
from mlx_vlm_tpu_torch.utils.loader import (get_model_and_args,
                                            load_model_from_weights,
                                            params_from_jax)
from mlx_vlm_tpu_torch.utils.testing import (llama_3_1_8b_config,
                                             llama_hf_weights,
                                             mlx_int4_checkpoint,
                                             tiny_llama_config)
from test_torch_qwen2_5_vl import bench_rule, jax_leaf, serve_chats, tree_equal

torch.set_num_threads(2)


def variant(kind: str, seed: int = 3) -> tuple:
    """(config, HF weights) of a tiny text model of `kind`: llama, mistral,
    qwen2 (q / k / v biases, tied head), qwen3 (per-head q / k norms, a
    head dim of its own) or llama3 (Llama-3.1's rope scaling, partial
    rotary)."""
    over = {
        "llama": {},
        "mistral": {"model_type": "mistral"},
        "qwen2": {"model_type": "qwen2", "tie_word_embeddings": True},
        "qwen3": {"model_type": "qwen3", "head_dim": 24},
        "llama3": {"rope_scaling": llama_3_1_8b_config()["rope_scaling"],
                   "rope_theta": 500000.0, "partial_rotary_factor": 0.5},
    }[kind]
    cfg = tiny_llama_config(**over)
    w = llama_hf_weights(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    hd = cfg.get("head_dim") or 16
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}.self_attn."
        if kind == "qwen2":
            for nm, n in (("q_proj", 4), ("k_proj", 2), ("v_proj", 2)):
                w[p + nm + ".bias"] = (rng.standard_normal(n * hd)
                                       * 0.05).astype(np.float32)
        if kind == "qwen3":
            for nm in ("q_norm", "k_norm"):
                w[p + nm + ".weight"] = (1 + 0.1 * rng.standard_normal(
                    hd)).astype(np.float32)
    return cfg, w


@pytest.fixture(scope="module", params=["llama", "mistral", "qwen2", "qwen3",
                                        "llama3"])
def pair(request):
    cfg, w = variant(request.param)
    return (jax_load(dict(cfg), dict(w), jnp.float32),
            load_model_from_weights(cfg, dict(w), torch.float32, "cpu"))


# ------------------------------------------------------------ host layouts


def test_published_config_parses_as_the_reference():
    from mlx_vlm_tpu.models.llama import TextConfig as JaxConfig

    d = llama_3_1_8b_config()
    got = TextConfig.from_dict(json.loads(json.dumps(d)))
    ref = JaxConfig.from_dict(json.loads(json.dumps(d)))
    assert got.__dict__ == ref.__dict__
    assert (got.hidden_size, got.num_hidden_layers, got.num_key_value_heads,
            got.intermediate_size, got.vocab_size) == (4096, 32, 8, 14336,
                                                       128256)


def test_weight_builder_and_sanitize_equal_reference():
    cfg = tiny_llama_config()
    assert cfg == jax_tiny_config()
    ref, got = jax_hf_weights(cfg, 3), llama_hf_weights(cfg, 3)
    assert list(got) == list(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    got["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(4)
    a, b = Model.sanitize(dict(got)), JaxModel.sanitize(dict(got))
    assert list(a) == list(b) and all(a[k] is b[k] for k in b)
    assert all(k.startswith("language_model.") for k in a)


def test_text_position_ids_equal_reference():
    ids = np.arange(14).reshape(2, 7)
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    for am in (None, mask):
        got, ref = text_position_ids(ids, am), jax_text_position_ids(ids, am)
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got, ref))


@pytest.mark.parametrize("model_type,module,as_type", [
    ("llama", "llama", "llama"), ("mistral", "text_only", "mistral"),
    ("qwen2", "llama", "llama"), ("qwen3", "llama", "llama"),
    ("llava", "llava", "llava"), ("llava_next", "llava", "llava")])
def test_model_types_dispatch_as_the_reference(model_type, module, as_type):
    cfg = {"model_type": model_type}
    if model_type.startswith("llava"):
        cfg["vision_config"] = {}
    arch, got = get_model_and_args(cfg)
    jarch, ref = jax_model_and_args(cfg)
    assert got == ref == as_type
    assert arch.__name__ == f"mlx_vlm_tpu_torch.models.{module}"
    assert jarch.__name__ == f"mlx_vlm_tpu.models.{module}"


def test_gemma_text_and_other_types_refused():
    # gemma and gemma2 run on paligemma's decoder through the text-only
    # fallback, as in the reference
    for model_type in ("gemma", "gemma2"):
        arch, got = get_model_and_args({"model_type": model_type})
        jarch, ref = jax_model_and_args({"model_type": model_type})
        assert got == ref == model_type
        assert arch.__name__ == "mlx_vlm_tpu_torch.models.text_only"
        assert jarch.__name__ == "mlx_vlm_tpu.models.text_only"
    with pytest.raises(NotImplementedError, match="idefics2"):
        get_model_and_args({"model_type": "idefics2", "vision_config": {}})
    # a llama-architecture type with a vision config is not text-only
    with pytest.raises(NotImplementedError, match="mistral"):
        get_model_and_args({"model_type": "mistral", "vision_config": {}})


# ------------------------------------------------------------ float paths


def _embeds(jm, tm, ids):
    return (jm.get_input_embeddings(jm.params, jnp.asarray(ids)),
            tm.get_input_embeddings(tm.params, torch.from_numpy(ids)))


def test_language_model_cached_uncached_and_captured(pair):
    """Cached prefill (forward_captured: its per-layer hiddens too), then
    decode steps on the JAX package's greedy tokens; and the uncached
    call, within 1e-4."""
    jm, tm = pair
    jlm, tlm = jm.language_model, tm.language_model
    jp, tp = jm.params["language_model"], tm.params["language_model"]
    ids = np.array([[5, 6, 7, 8, 9, 10, 11]])
    je, te = _embeds(jm, tm, ids)
    pos = jm.prepare_position_ids(ids)[0]
    tpos = torch.from_numpy(pos.astype(np.int64))
    jc = jlm.init_cache(1, 32, jnp.float32)
    tc = tlm.init_cache(1, 32, torch.float32)
    jh, jc, jhid = jlm.forward_captured(jp, je, jc, jnp.asarray(pos))
    th, thid = tlm.forward_captured(tp, te, tc, tpos)
    assert thid.shape == (2, 1, 7, 64)
    np.testing.assert_allclose(thid.numpy(), np.asarray(jhid), rtol=1e-4,
                               atol=1e-4)
    ref, got = [np.asarray(jlm.logits(jp, jh))[0, -1]], [
        tlm.logits(tp, th)[0, -1].numpy()]
    for _ in range(4):
        tok = np.array([[int(np.argmax(ref[-1]))]])
        je, te = _embeds(jm, tm, tok)
        p = int(jc.offset)
        jl, jc = jm(jm.params, je, jc, jnp.full((3, 1, 1), p, jnp.int32))
        ref.append(np.asarray(jl)[0, 0])
        got.append(tm(tm.params, te, tc, torch.full((3, 1, 1), p))[0, 0]
                   .numpy())
    assert int(tc.offset) == int(jc.offset) == 11
    ref, got = np.stack(ref), np.stack(got)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])
    je, te = _embeds(jm, tm, ids)
    jh, _ = jlm(jp, je, None, jnp.asarray(pos))
    np.testing.assert_allclose(tlm(tp, te, None, tpos).numpy(),
                               np.asarray(jh), rtol=1e-4, atol=1e-4)


def test_params_carry_over_from_jax(pair):
    jm, tm = pair
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))


# ------------------------------------------------------------ the loader


@pytest.mark.parametrize("mode", [None, "exact", "w4grp"])
def test_int4_checkpoint_through_both_loaders(mode, monkeypatch):
    """A 4-bit mlx checkpoint: w8chan by default (no fused step for this
    decoder, as in the reference), exact or w4grp (K1 / K2 per linear, the
    fused route off) on request; the same parameters as the JAX package's
    load, and its logits within 1e-3."""
    if mode:
        monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)
    cfg, w = mlx_int4_checkpoint(tiny_llama_config(hidden_size=128,
                                                   intermediate_size=256),
                                 seed=4)
    tm = load_model_from_weights(cfg, w, torch.float32, "cpu")
    lp = tm.params["language_model"]
    kinds = {None: (ChannelQuantizedTensor,) * 3,
             "exact": (QuantizedTensor,) * 3,
             "w4grp": (Int4GroupedTensor, Int4GroupedTensor,
                       ChannelQuantizedTensor)}[mode]
    for leaf, kind in zip((lp["model"]["layers"]["mlp"]["up_proj"]["weight"],
                           lp["lm_head"]["weight"],
                           lp["model"]["embed_tokens"]["weight"]), kinds):
        assert isinstance(leaf, kind)
    assert not tm.language_model.fused_decode
    jm = jax_load(dict(cfg), {k: jax_leaf(v) for k, v in w.items()},
                  jnp.float32)
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    ids = np.array([[3, 1, 4, 1, 5, 9, 2, 6]])
    pos = tm.prepare_position_ids(ids)[0]
    jl, _ = jm(jm.params, jm.get_input_embeddings(jm.params, jnp.asarray(
        ids)), jm.language_model.init_cache(1, 16, jnp.float32),
        jnp.asarray(pos))
    tl = tm(tm.params, tm.get_input_embeddings(tm.params, torch.from_numpy(
        ids)), tm.language_model.init_cache(1, 16, torch.float32),
        torch.from_numpy(pos.astype(np.int64)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-3)


# ------------------------------------------------------------ end to end

# a byte tokenizer's special tokens inside the tiny vocabulary
SPECIALS = {"<|im_start|>": 256, "<|im_end|>": 257, "<|endoftext|>": 258}


@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    """(JAX model, port model, processor): one tiny llama checkpoint on
    disk through both packages' `load_model`, and the port's processor
    over a byte tokenizer (no transformers), which both packages take."""
    from mlx_vlm_tpu.utils.loader import load_model as jax_load_model

    from mlx_vlm_tpu_torch.utils.loader import load_model, write_safetensors
    from mlx_vlm_tpu_torch.utils.processing import processor_for
    from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

    d = tmp_path_factory.mktemp("tiny_llama")
    cfg = tiny_llama_config(vocab_size=320, eos_token_id=257)
    write_safetensors(d / "model.safetensors",
                      llama_hf_weights(cfg, seed=11, scale=0.5))
    (d / "config.json").write_text(json.dumps(cfg))
    tm = load_model(d, dtype=torch.float32, device="cpu")
    return (jax_load_model(d, dtype=jnp.float32), tm,
            processor_for(ByteTokenizer(SPECIALS), tm))


def test_generate_batch_and_server_match_jax(on_disk):
    """Greedy stream_generate, batch_generate of three prompts and one
    served chat: the port's tokens are the JAX package's."""
    from mlx_vlm_tpu.generate.batch import batch_generate as jbatch

    from mlx_vlm_tpu_torch.generate.batch import batch_generate

    jm, tm, proc = on_disk
    texts = ["Describe a cat.", "What is a mat?", "Hello there."]
    prompts = [mlx_vlm_tpu_torch.apply_chat_template(proc, tm.config_dict, t)
               for t in texts]
    assert prompts == [mlx_vlm_tpu.apply_chat_template(proc, jm.config_dict,
                                                       t) for t in texts]
    jt = [r.token for r in mlx_vlm_tpu.stream_generate(
        jm, proc, prompts[0], max_tokens=8, prefill_step_size=64)]
    tt = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
        tm, proc, prompts[0], max_tokens=8, prefill_step_size=64)]
    assert tt == jt and len(tt) == 8
    ref = jbatch(jm, proc, prompts, max_tokens=6, num_slots=2, capacity=256)
    got = batch_generate(tm, proc, prompts, max_tokens=6, num_slots=2,
                         capacity=256)
    assert got.texts == ref.texts
    body = {"messages": [{"role": "user", "content": "Describe a cat."}],
            "max_tokens": 6}
    out = serve_chats([("jax", jm, proc), ("port", tm, proc)], [body],
                      "tiny-llama")
    assert (out["port"][0]["choices"][0]["message"]["content"]
            == out["jax"][0]["choices"][0]["message"]["content"])
    assert out["port"][0]["usage"] == out["jax"][0]["usage"]
