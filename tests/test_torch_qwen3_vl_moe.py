"""Port parity: the Qwen3-VL-MoE family (models/qwen3_vl_moe) against the
JAX package on the CPU, modelled on tests/test_qwen3_vl_moe.py (hidden 48,
4 decoder layers of 4 experts of width 32, 2 a token; the 3-block
deepstack tower):

- the HF and mlx fused expert layouts give the same logits; the refusal of
  mixed layers; the expert stack's shape; the weight draws and
  `sanitize` equal to the JAX package's; the published config parsed as
  the JAX package parses it;
- the whole tiny model's teacher-forced logits (f32, within 1e-3 and by
  bench.py's rule) and greedy tokens against the JAX package's
  `generate_step`; in bf16 the full-sequence logits by bench.py's rule;
- random 4-bit mlx checkpoints with an 8-bit router (per-path entries),
  in the default mode (w8chan linears and router, the experts exact) and
  in `exact`: the port's parameter tree byte-equal to the JAX package's
  carried by `params_from_jax`, the logits by bench.py's rule;
- a text row and an image row admitted together through `BatchGenerator`
  (each decodes its prompt's tokens alone), a served chat through
  `create_server` answering as the JAX package's server, and a prefix-cache
  warm turn giving the cold turn's tokens.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.generate.ar import generate_step as jax_generate_step
from mlx_vlm_tpu.models.qwen3_vl_moe import ModelConfig as JaxConfig
from mlx_vlm_tpu.models.qwen3_vl_moe.qwen3_vl_moe import Model as JaxModel
from mlx_vlm_tpu.models.qwen3_vl_moe.qwen3_vl_moe import \
    TextConfig as JaxTextConfig
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu_torch.core.quant import (ChannelQuantizedTensor,
                                          QuantizedTensor)
from mlx_vlm_tpu_torch.generate import ar
from mlx_vlm_tpu_torch.models.qwen3_vl_moe import Model, ModelConfig
from mlx_vlm_tpu_torch.utils.loader import (get_model_and_args,
                                            load_model_from_weights)
from mlx_vlm_tpu_torch.utils.testing import (mlx_quantized_checkpoint,
                                             qwen3_vl_moe_30b_a3b_config,
                                             qwen3_vl_moe_hf_weights,
                                             tiny_qwen3_vl_moe_config)
from test_qwen3_vl_moe import tiny_moe_config as jax_tiny_config
from test_qwen3_vl_moe import tiny_moe_weights as jax_tiny_weights
from test_torch_qwen2_5_vl import (bench_rule, image_inputs, jax_leaf,
                                   port_of, serve_chats, teacher_forced,
                                   tree_equal, write_checkpoint)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_qwen3_vl_moe_config()
    jm = jax_load(dict(cfg), jax_tiny_weights(jax_tiny_config(), 5),
                  jnp.float32)
    return jm, port_of(jm, Model, ModelConfig, cfg), cfg


def _positions(S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (3, 1, S)).copy()


def _logits(tm, ids, pos):
    e = tm.get_input_embeddings(tm.params, torch.from_numpy(ids))
    return tm(tm.params, e, None, torch.from_numpy(pos.astype(np.int64)))


# ------------------------------------------------------------ layouts


def test_hf_and_mlx_layouts_agree():
    cfg = tiny_qwen3_vl_moe_config()
    m1, m2 = (load_model_from_weights(
        cfg, qwen3_vl_moe_hf_weights(cfg, layout=layout), torch.float32,
        "cpu") for layout in ("hf", "mlx"))
    ids = (np.arange(5, dtype=np.int64) % 200)[None]
    l1, l2 = _logits(m1, ids, _positions(5)), _logits(m2, ids, _positions(5))
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-5)


def test_heterogeneous_layers_rejected():
    for change in ({"mlp_only_layers": [0]}, {"decoder_sparse_step": 2}):
        cfg = tiny_qwen3_vl_moe_config()
        cfg["text_config"].update(change)
        with pytest.raises(ValueError, match="MoE"):
            ModelConfig.from_dict(cfg)
        with pytest.raises(ValueError, match="MoE"):
            JaxConfig.from_dict(cfg)


def test_expert_stack_shape():
    cfg = tiny_qwen3_vl_moe_config()
    m = load_model_from_weights(cfg, qwen3_vl_moe_hf_weights(cfg),
                                torch.float32, "cpu")
    mlp = m.params["language_model"]["model"]["layers"]["mlp"]
    assert mlp["experts"]["gate_proj"]["weight"].shape == (4, 4, 32, 48)
    assert mlp["experts"]["up_proj"]["weight"].shape == (4, 4, 32, 48)
    assert mlp["experts"]["down_proj"]["weight"].shape == (4, 4, 48, 32)
    assert mlp["gate"]["weight"].shape == (4, 4, 48)  # [L, E, D]
    assert type(m).__module__.endswith("qwen3_vl_moe.qwen3_vl_moe")


@pytest.mark.parametrize("layout", ["hf", "mlx"])
def test_weights_and_sanitize_equal_reference(layout):
    cfg = tiny_qwen3_vl_moe_config()
    assert cfg == jax_tiny_config()
    ref = jax_tiny_weights(jax_tiny_config(), 3, layout=layout)
    got = qwen3_vl_moe_hf_weights(cfg, seed=3, layout=layout)
    assert list(got) == list(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    a, b = Model.sanitize(dict(got)), JaxModel.sanitize(dict(ref))
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
               for k in b)


def test_published_config_parses_as_the_reference():
    """Qwen3-VL-30B-A3B's typed widths parse as the JAX package parses
    them, and its expert fields are the JAX TextConfig's defaults
    (qwen3_vl_moe.py:27-36)."""
    d = qwen3_vl_moe_30b_a3b_config()
    got = ModelConfig.from_dict(json.loads(json.dumps(d)))
    ref = JaxConfig.from_dict(json.loads(json.dumps(d)))
    assert got.text_config.__dict__ == ref.text_config.__dict__
    assert got.vision_config.__dict__ == ref.vision_config.__dict__
    tc, vc = got.text_config, got.vision_config
    assert (tc.hidden_size, tc.num_hidden_layers, tc.num_attention_heads,
            tc.num_key_value_heads, tc.head_dim, tc.vocab_size) == (
                2048, 48, 32, 4, 128, 151936)
    jd = JaxTextConfig()
    assert (tc.num_experts, tc.num_experts_per_tok,
            tc.moe_intermediate_size, tc.norm_topk_prob,
            tc.decoder_sparse_step, tc.mlp_only_layers) == (
                jd.num_experts, jd.num_experts_per_tok,
                jd.moe_intermediate_size, jd.norm_topk_prob,
                jd.decoder_sparse_step, jd.mlp_only_layers)
    assert (vc.depth, vc.hidden_size, vc.out_hidden_size, vc.patch_size,
            vc.deepstack_visual_indexes) == (27, 1152, 2048, 16, [8, 16, 24])
    assert get_model_and_args(d)[0].__name__.endswith("qwen3_vl_moe")


# ------------------------------------------------------------ float paths


@pytest.mark.parametrize("grid", ([[1, 4, 4]], [[1, 6, 8]]))
def test_teacher_forced_logits(models, grid):
    jm, tm, _ = models
    ids, pix, grid = image_inputs(tm, grid)
    ref, got = teacher_forced(jm, tm, ids, pix, grid)
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_greedy_tokens_match_generate_step(models):
    jm, tm, _ = models
    ids = (np.arange(3, 12, dtype=np.int64) * 7 % 200)[None]
    je = jax.jit(jm.get_input_embeddings)(jm.params, jnp.asarray(ids))
    want = [int(t[0]) for t, _ in jax_generate_step(je, jm, max_tokens=8)]
    te = tm.get_input_embeddings(tm.params, torch.from_numpy(ids))
    got = [int(t[0]) for t, _ in ar.generate_step(te, tm, max_tokens=8)]
    assert got == want and len(got) == 8


def test_bf16_logits_by_the_bench_rule():
    cfg = tiny_qwen3_vl_moe_config()
    w = jax_tiny_weights(jax_tiny_config(), 6)
    jm = jax_load(dict(cfg), w, jnp.bfloat16)
    tm = load_model_from_weights(cfg, qwen3_vl_moe_hf_weights(cfg, 6),
                                 torch.bfloat16, "cpu")
    ids, pix, grid = image_inputs(tm, [[1, 4, 6]])
    pos, _ = tm.prepare_position_ids(ids, grid)
    jaux = {k: jnp.asarray(v) for k, v in jm.vision_aux_inputs(grid).items()}
    taux = {k: torch.from_numpy(v)
            for k, v in tm.vision_aux_inputs(grid).items()}
    je = jm.get_input_embeddings(jm.params, jnp.asarray(ids),
                                 jnp.asarray(pix, jnp.bfloat16), **jaux)
    ref = np.asarray(jm(jm.params, je, None, jnp.asarray(pos))[0][0].astype(
        jnp.float32))
    te = tm.get_input_embeddings(
        tm.params, torch.from_numpy(ids),
        torch.from_numpy(pix).to(torch.bfloat16), **taux)
    got = tm(tm.params, te, None, torch.from_numpy(pos.astype(np.int64)))
    got = got[0].float().numpy()
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])


# ------------------------------------------------------------ checkpoints


def _mlx_moe_config():
    """The tiny model at widths that take groups of 64: hidden 128, experts
    of width 64, heads of 32 (M-RoPE sections [8, 4, 4])."""
    cfg = tiny_qwen3_vl_moe_config()
    cfg["text_config"].update(
        hidden_size=128, moe_intermediate_size=64, head_dim=32,
        intermediate_size=256,
        rope_scaling={"type": "default", "mrope_section": [8, 4, 4]})
    cfg["vision_config"] = dict(cfg["vision_config"], out_hidden_size=128)
    return cfg


@pytest.mark.parametrize("mode", [None, "exact"])
def test_mlx_checkpoint_with_an_8bit_router(monkeypatch, mode):
    """4-bit linears and experts, 8-bit routers under per-path entries.
    Default mode: w8chan linears and routers (from 8 bits), the expert
    stacks exact; exact: every triple a QuantizedTensor at its own bits.
    The port's tree is byte-equal to the JAX package's, and the logits
    agree by bench.py's rule."""
    if mode:
        monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)
    else:
        monkeypatch.delenv("MLX_VLM_TPU_RUNTIME_QUANT", raising=False)
    cfg, w = mlx_quantized_checkpoint(_mlx_moe_config(), bits=4, seed=8,
                                      router_bits=8)
    paths = [k for k in cfg["quantization"] if k.endswith(".mlp.gate")]
    assert len(paths) == 4 and cfg["quantization"][paths[0]]["bits"] == 8
    tm = load_model_from_weights(cfg, w, torch.float32, "cpu")
    lp = tm.params["language_model"]
    mlp = lp["model"]["layers"]["mlp"]
    router = mlp["gate"]["weight"]
    experts = mlp["experts"]["gate_proj"]["weight"]
    q = lp["model"]["layers"]["self_attn"]["q_proj"]["weight"]
    assert isinstance(experts, QuantizedTensor) and experts.bits == 4
    assert experts.q.shape == (4, 4, 64, 64)  # [L, E, I, D * 4 / 8]
    if mode == "exact":
        assert isinstance(router, QuantizedTensor) and router.bits == 8
        assert isinstance(q, QuantizedTensor) and q.bits == 4
    else:
        assert isinstance(router, ChannelQuantizedTensor)
        assert router.src_bits == 8
        assert isinstance(q, ChannelQuantizedTensor) and q.src_bits == 4
    jm = jax_load(dict(cfg), {k: jax_leaf(v) for k, v in w.items()},
                  jnp.float32)
    tree_equal(tm.params, port_of(jm, Model, ModelConfig, cfg).params)
    ids = (np.arange(4, 14, dtype=np.int64) * 11 % 200)[None]
    pos = _positions(ids.shape[1])
    ref = np.asarray(jm(jm.params, jm.get_input_embeddings(
        jm.params, jnp.asarray(ids)), None, jnp.asarray(pos))[0][0])
    got = _logits(tm, ids, pos)[0].numpy()
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


# ------------------------------------------------------------ entry points


def test_text_and_image_rows_admitted_together(models):
    from mlx_vlm_tpu_torch.generate.batch import BatchGenerator, BatchRequest
    from mlx_vlm_tpu_torch.generate.common import embed_prompt

    _, tm, _ = models
    ids, pix, grid = image_inputs(tm, [[1, 4, 4]])
    image = {"input_ids": ids, "pixel_values": pix, "image_grid_thw": grid,
             "attention_mask": np.ones_like(ids)}
    text = {"input_ids": np.arange(20, 31)[None]}
    prompts = [embed_prompt(tm, x) for x in (text, image)]
    assert [p[0].shape[-1] for p in prompts] == [48, 144]
    gen = BatchGenerator(tm, num_slots=2, capacity=128, dtype=torch.float32)
    for u, (e, p, d) in enumerate(prompts):
        gen.insert(BatchRequest(uid=u, inputs_embeds=e, max_tokens=5,
                                position_ids=p, rope_delta=int(d[0, 0])))
    out = {0: [], 1: []}
    while gen.num_active or gen.queue:
        for uid, pairs in gen.next().items():
            out[uid].extend(t for t, _ in pairs)
    assert gen.stats["admissions"] == 1
    for u, (e, p, d) in enumerate(prompts):
        alone = [int(t[0]) for t, _ in ar.generate_step(
            e, tm, position_ids=p, rope_deltas=d, max_tokens=5)]
        assert out[u] == alone


def _tiny_on_disk(base):
    cfg = tiny_qwen3_vl_moe_config(
        image_token_id=base["image_token_id"],
        video_token_id=base["video_token_id"],
        vision_start_token_id=base["vision_start_token_id"],
        eos_token_id=base["eos_token_id"])
    cfg["text_config"] = dict(cfg["text_config"],
                              vocab_size=base["vocab_size"])
    return cfg


def test_served_chat_and_stream_generate_on_a_checkpoint(tmp_path):
    """A checkpoint on disk loads by its type in both packages; greedy
    `stream_generate` gives the JAX package's tokens, and a text chat
    served by `create_server` on the CPU answers as the JAX package's
    server does."""
    write_checkpoint(tmp_path, _tiny_on_disk,
                     lambda c: qwen3_vl_moe_hf_weights(c, seed=11))
    jm, jp = mlx_vlm_tpu.load(str(tmp_path), dtype=jnp.float32)
    tm, tp = mlx_vlm_tpu_torch.load(str(tmp_path), dtype=torch.float32,
                                    device="cpu")
    assert isinstance(tm, Model)
    prompt = mlx_vlm_tpu_torch.apply_chat_template(tp, tm.config_dict,
                                                   "Describe a cat.")
    assert prompt == mlx_vlm_tpu.apply_chat_template(jp, jm.config_dict,
                                                     "Describe a cat.")
    jt = [r.token for r in mlx_vlm_tpu.stream_generate(jm, jp, prompt,
                                                       max_tokens=6)]
    tt = [r.token for r in mlx_vlm_tpu_torch.stream_generate(tm, tp, prompt,
                                                             max_tokens=6)]
    assert tt == jt and len(tt) == 6
    body = {"messages": [{"role": "user", "content": "Describe a cat."}],
            "max_tokens": 6}
    out = serve_chats([("jax", jm, jp), ("port", tm, tp)], [body],
                      "tiny-qwen3-vl-moe")
    assert (out["port"][0]["choices"][0]["message"]["content"]
            == out["jax"][0]["choices"][0]["message"]["content"])
    assert out["port"][0]["usage"]["completion_tokens"] == 6


def test_prefix_cache_warm_turn(models):
    """A warm turn from the prefix cache (apc.py's block mode: the prompt's
    16-token blocks harvested from the cold turn's cache, restored into a
    warm cache) gives the cold turn's greedy tokens, as in the JAX
    package."""
    from test_torch_apc import _warm_vs_cold

    jm, tm, _ = models
    jcold, jwarm = _warm_vs_cold("jax", jm)
    cold, warm = _warm_vs_cold("port", tm)
    assert warm == cold == jwarm == jcold
