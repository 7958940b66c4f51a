"""Port parity: gpt-oss (models/gpt_oss: attention sinks, alternating
sliding / full layers, the clipped-SwiGLU experts with their biases)
against the JAX package, in float32 on the CPU on numpy-seeded weights at
the JAX package's test size (`tiny_gpt_oss_config`: hidden 32, 2 layers,
window 4, 4 experts, top-2).

- `sanitize` key for key on the HF layout, and the mlx layout (split
  expert stacks) to the same parameters;
- logits without a cache and teacher-forced through the cache (a
  10-token prefill, longer than the window, then 4 decode steps), and a
  left-padded batch of two rows, within 1e-4;
- YaRN's `truncate` (ROADMAP Queue 3, known faults): with gpt-oss's
  `truncate: false` the port follows transformers' GptOssForCausalLM
  (within 1e-4 of its logits at positions past 3000), where the JAX
  package, which always rounds the correction range, differs; with
  `truncate: true` the port equals the JAX package;
- a checkpoint on disk through `load`: greedy `stream_generate`,
  `batch_generate` and one served chat give the JAX package's tokens; a
  4-bit mlx checkpoint loads its expert stacks exact (K5's layout) in the
  default mode beside per-channel linears, as the JAX package does.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.utils.loader import get_model_and_args as jax_model_and_args
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu_torch.core.quant import (ChannelQuantizedTensor,
                                          QuantizedTensor)
from mlx_vlm_tpu_torch.models.llama.llama import text_position_ids
from mlx_vlm_tpu_torch.utils.loader import (get_model_and_args,
                                            load_model_from_weights,
                                            params_from_jax)
from mlx_vlm_tpu_torch.utils.testing import (classic_hf_weights,
                                             gpt_oss_20b_config,
                                             mlx_quantized_checkpoint,
                                             tiny_gpt_oss_config)
from test_torch_qwen2_5_vl import jax_leaf, serve_chats, tree_equal

torch.set_num_threads(2)

IDS = (np.arange(10, dtype=np.int64) * 5 % 90)[None]
YARN = {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
        "beta_slow": 1.0, "original_max_position_embeddings": 4096}


def _pair(cfg, w):
    return (jax_load(dict(cfg), dict(w), jnp.float32),
            load_model_from_weights(cfg, dict(w), torch.float32, "cpu"))


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_gpt_oss_config()
    return _pair(cfg, classic_hf_weights(cfg, seed=2))


def _pos(S, start=0, B=1):
    return np.broadcast_to(np.arange(start, start + S, dtype=np.int32),
                           (3, B, S)).copy()


def test_published_config_and_sanitize_equal_reference():
    d = gpt_oss_20b_config()
    arch, kind = get_model_and_args(d)
    jarch, jkind = jax_model_and_args(d)
    assert kind == jkind == "gpt_oss"
    assert (arch.ModelConfig.from_dict(d).__dict__
            == jarch.ModelConfig.from_dict(d).__dict__)
    cfg = tiny_gpt_oss_config()
    w = classic_hf_weights(cfg, seed=3)
    w["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(4)
    a, b = arch.Model.sanitize(dict(w)), jarch.Model.sanitize(dict(w))
    assert list(a) == list(b)
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in b)


def test_mlx_layout_loads_the_same_parameters(pair):
    """The HF arrays re-laid as the mlx conversion's split stacks (gate
    the even columns of gate_up_proj, up the odd, down transposed) load
    to the same tree as the HF layout."""
    cfg = tiny_gpt_oss_config()
    hf = classic_hf_weights(cfg, seed=2)
    mlx = {}
    for k, v in hf.items():
        x = k.rsplit("experts.", 1)
        if len(x) == 1:
            mlx[k] = v
        elif x[1] == "gate_up_proj":
            mlx[x[0] + "experts.gate_proj.weight"] = v[..., ::2].swapaxes(1, 2)
            mlx[x[0] + "experts.up_proj.weight"] = v[..., 1::2].swapaxes(1, 2)
        elif x[1] == "gate_up_proj_bias":
            mlx[x[0] + "experts.gate_proj.bias"] = v[..., ::2]
            mlx[x[0] + "experts.up_proj.bias"] = v[..., 1::2]
        elif x[1] == "down_proj":
            mlx[x[0] + "experts.down_proj.weight"] = v.swapaxes(1, 2)
        else:
            mlx[x[0] + "experts.down_proj.bias"] = v
    tm = load_model_from_weights(cfg, mlx, torch.float32, "cpu")
    tree_equal(pair[1].params, tm.params)


def test_params_carry_over_from_jax(pair):
    jm, tm = pair
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))


def test_logits_without_and_with_cache(pair):
    jm, tm = pair
    S = IDS.shape[1]
    je = jm.get_input_embeddings(jm.params, jnp.asarray(IDS))
    te = tm.get_input_embeddings(tm.params, torch.from_numpy(IDS))
    ref = np.asarray(jm(jm.params, je, None, jnp.asarray(_pos(S)))[0])
    got = tm(tm.params, te, None, torch.from_numpy(_pos(S))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    jc = jm.language_model.init_cache(1, 32, jnp.float32)
    tc = tm.language_model.init_cache(1, 32, torch.float32)
    jl, jc = jm(jm.params, je, jc, jnp.asarray(_pos(S)))
    tl = tm(tm.params, te, tc, torch.from_numpy(_pos(S)))
    refs, gots = [np.asarray(jl)[0, -1]], [tl[0, -1].numpy()]
    for t in range(4):
        tok = np.array([[int(np.argmax(refs[-1]))]])
        jl, jc = jm(jm.params, jm.get_input_embeddings(
            jm.params, jnp.asarray(tok)), jc, jnp.asarray(_pos(1, S + t)))
        tl = tm(tm.params, tm.get_input_embeddings(
            tm.params, torch.from_numpy(tok)), tc,
            torch.from_numpy(_pos(1, S + t)))
        refs.append(np.asarray(jl)[0, 0])
        gots.append(tl[0, 0].numpy())
    assert int(tc.offset) == int(jc.offset) == S + 4
    np.testing.assert_allclose(np.stack(gots), np.stack(refs), rtol=1e-4,
                               atol=1e-4)


def test_left_padded_batch(pair):
    """Two rows, the second left-padded by 3, prefilled through the cache
    with its left_pad: every valid position's logits within 1e-4."""
    jm, tm = pair
    ids = np.stack([IDS[0], np.concatenate([[0, 0, 0], IDS[0, :7]])])
    am = np.ones_like(ids)
    am[1, :3] = 0
    pos, _ = text_position_ids(ids, am)
    lp = np.array([0, 3], np.int32)
    jc = jm.language_model.init_cache(2, 16, jnp.float32,
                                      left_pad=jnp.asarray(lp))
    tc = tm.language_model.init_cache(2, 16, torch.float32,
                                      left_pad=torch.from_numpy(lp))
    jl, _ = jm(jm.params, jm.get_input_embeddings(
        jm.params, jnp.asarray(ids)), jc, jnp.asarray(pos))
    tl = tm(tm.params, tm.get_input_embeddings(
        tm.params, torch.from_numpy(ids)), tc, torch.from_numpy(pos))
    ref, got = np.asarray(jl), tl.numpy()
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1, 3:], ref[1, 3:], rtol=1e-4, atol=1e-4)


def _hf_gpt_oss(cfg, w):
    from transformers import GptOssConfig, GptOssForCausalLM

    hf = GptOssForCausalLM(GptOssConfig(**{
        k: v for k, v in cfg.items() if k != "model_type"},
        attn_implementation="eager")).float().eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()},
                       strict=True)
    return hf


@pytest.mark.parametrize("truncate", [False, True])
def test_yarn_truncate_follows_transformers(truncate):
    """Fault 1 (ROADMAP Queue 3): at positions 3000-3009, the port within
    1e-4 of transformers' GptOssForCausalLM in both cases; the JAX
    package equals the port with `truncate: true` and differs (it rounds
    the correction range regardless) with `truncate: false`."""
    cfg = tiny_gpt_oss_config(rope_scaling={**YARN, "truncate": truncate},
                              max_position_embeddings=131072)
    w = classic_hf_weights(cfg, seed=4, scale=0.2)
    jm, tm = _pair(cfg, w)
    S = IDS.shape[1]
    pos = _pos(S, 3000)
    got = tm(tm.params, tm.get_input_embeddings(
        tm.params, torch.from_numpy(IDS)), None,
        torch.from_numpy(pos)).numpy()
    with torch.no_grad():
        hf = _hf_gpt_oss(cfg, w)(
            input_ids=torch.from_numpy(IDS),
            position_ids=torch.from_numpy(pos[0].astype(np.int64))
        ).logits.numpy()
    ref = np.asarray(jm(jm.params, jm.get_input_embeddings(
        jm.params, jnp.asarray(IDS)), None, jnp.asarray(pos))[0])
    np.testing.assert_allclose(got, hf, rtol=1e-4, atol=1e-4)
    if truncate:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(ref - hf).max() > 100 * np.abs(got - hf).max()


SPECIALS = {"<|im_start|>": 256, "<|im_end|>": 257, "<|endoftext|>": 258}


@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    from mlx_vlm_tpu.utils.loader import load_model as jax_load_model

    from mlx_vlm_tpu_torch.utils.loader import load_model, write_safetensors
    from mlx_vlm_tpu_torch.utils.processing import processor_for
    from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

    d = tmp_path_factory.mktemp("tiny_gpt_oss")
    cfg = tiny_gpt_oss_config(vocab_size=320, eos_token_id=257)
    write_safetensors(d / "model.safetensors",
                      classic_hf_weights(cfg, seed=11, scale=0.3))
    (d / "config.json").write_text(json.dumps(cfg))
    tm = load_model(d, dtype=torch.float32, device="cpu")
    return (jax_load_model(d, dtype=jnp.float32), tm,
            processor_for(ByteTokenizer(SPECIALS), tm))


def test_generate_batch_and_server_match_jax(on_disk):
    from mlx_vlm_tpu.generate.batch import batch_generate as jbatch

    from mlx_vlm_tpu_torch.generate.batch import batch_generate

    jm, tm, proc = on_disk
    texts = ["Describe a cat.", "What is a mat?", "Hello there."]
    prompts = [mlx_vlm_tpu_torch.apply_chat_template(proc, tm.config_dict, t)
               for t in texts]
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
                      "tiny-gpt-oss")
    assert (out["port"][0]["choices"][0]["message"]["content"]
            == out["jax"][0]["choices"][0]["message"]["content"])


@pytest.mark.parametrize("mode", [None, "exact"])
def test_mlx_4bit_checkpoint_layouts(monkeypatch, mode):
    """A 4-bit mlx checkpoint (hidden 64, group 32): the expert stacks stay
    exact in every mode (the fold takes 2-D triples only), the linears,
    router and head per-channel by default and exact under exact; the
    parameters equal the JAX package's load; greedy generate runs."""
    if mode:
        monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)
    cfg = tiny_gpt_oss_config(hidden_size=64, intermediate_size=64,
                              vocab_size=128)
    cfg, w = mlx_quantized_checkpoint(cfg, group_size=32, seed=6)
    tm = load_model_from_weights(cfg, dict(w), torch.float32, "cpu")
    jm = jax_load(cfg, {k: jax_leaf(v) for k, v in w.items()}, jnp.float32)
    lay = tm.params["language_model"]["model"]["layers"]
    layout = QuantizedTensor if mode else ChannelQuantizedTensor
    assert isinstance(lay["mlp"]["experts"]["gate_proj"]["weight"],
                      QuantizedTensor)
    assert isinstance(lay["mlp"]["router"]["weight"], layout)
    assert isinstance(lay["self_attn"]["q_proj"]["weight"], layout)
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    e = tm.get_input_embeddings(tm.params, torch.from_numpy(IDS))
    out = tm(tm.params, e, None, torch.from_numpy(_pos(IDS.shape[1])))
    assert np.all(np.isfinite(out.numpy()))
