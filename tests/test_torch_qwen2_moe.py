"""Port parity: the Qwen-MoE decoder (models/qwen2_moe; Qwen3-MoE
checkpoints load as it) against the JAX package on the CPU, beyond what
tests/test_torch_moe_text_families.py holds for every text MoE type:

- the shared expert and its sigmoid gate (f32): the layer against a
  plain sum of its parts, and with the card's decode route it makes no
  host read;
- random 4-bit mlx checkpoints of qwen2_moe (the routers and the N = 1
  shared-expert gate at 8 bits) and qwen3_moe, default mode (w8chan
  linears and routers, the expert stacks exact) and exact: the port's
  tree on the HF per-expert layout byte-equal to the JAX package's, its
  logits within 1e-3, and the mlx `switch_mlp` layout agreeing with it;
- the route rules at the routers' widths and the gate's N = 1 (K5's 2-D
  GEMV and GEMM plans), and the prefill route's repair for an expert
  slice of an odd number of groups;
- a tiny qwen3_moe checkpoint on disk: greedy `stream_generate`,
  `batch_generate` and a `BatchGenerator` admission, and one served chat,
  token for token as the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu_torch.core import moe
from mlx_vlm_tpu_torch.core import quant as tq
from mlx_vlm_tpu_torch.core.layers import linear, swiglu_mlp
from mlx_vlm_tpu_torch.generate import ar
from mlx_vlm_tpu_torch.ops import qmatmul as k5
from mlx_vlm_tpu_torch.utils.loader import (load_model_from_weights,
                                            params_from_jax)
from mlx_vlm_tpu_torch.utils.testing import (mlx_quantized_checkpoint,
                                             moe_text_hf_weights,
                                             tiny_moe_text_config)
from test_torch_moe import _NoHostReads, _quantized, _stacks
from test_torch_moe_text_families import _logits, _per_expert_layout
from test_torch_qwen2_5_vl import bench_rule, jax_leaf, serve_chats, tree_equal

torch.set_num_threads(2)

IDS = (np.arange(4, 14, dtype=np.int64) * 11 % 200)[None]


@pytest.fixture(scope="module")
def qwen2_moe():
    cfg = tiny_moe_text_config("qwen2_moe")
    return load_model_from_weights(cfg, moe_text_hf_weights(cfg, seed=2),
                                   torch.float32, "cpu")


# ------------------------------------------------------------ the layer


def test_shared_expert_is_gated_in_f32(qwen2_moe):
    """The layer is the routed experts' sum plus sigmoid(gate(x)) times the
    shared SwiGLU, the sigmoid taken on f32 logits."""
    lm = qwen2_moe.language_model
    p = qwen2_moe.params["language_model"]["model"]["layers"]
    from mlx_vlm_tpu_torch.models.base import layer_view

    mlp = layer_view(p, 1)["mlp"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, 64)).astype(np.float32))
    flat = x.reshape(10, 64)
    idx, wts = moe.topk_router(flat, mlp["gate"]["weight"], 2, False)
    e = mlp["experts"]
    routed = moe.switch_glu_scan(flat, e["gate_proj"]["weight"],
                                 e["up_proj"]["weight"],
                                 e["down_proj"]["weight"], idx, wts)
    gate = torch.sigmoid(linear(mlp["shared_expert_gate"], flat).double())
    want = routed.double() + gate * swiglu_mlp(mlp["shared_expert"],
                                               flat).double()
    got = lm._mlp(mlp, x).reshape(10, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert mlp["shared_expert_gate"]["weight"].shape == (1, 64)


def test_decode_route_with_the_shared_expert_makes_no_host_read(
        qwen2_moe, monkeypatch):
    """A decode step's MoE layer on the card's decode route (its plain
    versions here) with the shared expert and its gate: no operator reads
    a value on the host, so the step can be captured."""
    lm = qwen2_moe.language_model
    from mlx_vlm_tpu_torch.models.base import layer_view

    mlp = layer_view(qwen2_moe.params["language_model"]["model"]["layers"],
                     0)["mlp"]
    monkeypatch.setattr(moe, "_route", moe.pairs_route)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 1, 64)).astype(np.float32))
    with _NoHostReads():
        got = lm._mlp(mlp, x)
    monkeypatch.undo()
    np.testing.assert_allclose(got.numpy(), lm._mlp(mlp, x).numpy(),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ checkpoints


def _quantized_config(kind):
    return tiny_moe_text_config(kind, hidden_size=128,
                                moe_intermediate_size=64, head_dim=32,
                                shared_expert_intermediate_size=128,
                                intermediate_size=256)


@pytest.mark.parametrize("mode", [None, "exact"])
@pytest.mark.parametrize("kind", ["qwen2_moe", "qwen3_moe"])
def test_mlx_checkpoint_through_both_loaders(monkeypatch, kind, mode):
    """4-bit linears and experts, 8-bit routers (and qwen2_moe's 8-bit
    N = 1 shared-expert gate) under per-path entries.  On the HF
    per-expert layout, which the JAX package loads, the port's tree is
    byte-equal to the JAX package's and its logits within 1e-3; the mlx
    `switch_mlp` layout keeps the stacks exact in every mode and agrees
    with it (to 1e-3 in exact, where both hold the same codes; by bench.py's
    rule by default, where the per-expert triples are requantized
    per-channel)."""
    if mode:
        monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)
    else:
        monkeypatch.delenv("MLX_VLM_TPU_RUNTIME_QUANT", raising=False)
    cfg, w = mlx_quantized_checkpoint(_quantized_config(kind), seed=8,
                                      router_bits=8)
    paths = [k for k in cfg["quantization"] if k.startswith("model.")]
    assert len(paths) == (4 if kind == "qwen2_moe" else 2)
    hf = _per_expert_layout(kind, w)
    tm = load_model_from_weights(cfg, dict(hf), torch.float32, "cpu")
    jm = jax_load(dict(cfg), {k: jax_leaf(v) for k, v in hf.items()},
                  jnp.float32)
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    S = IDS.shape[1]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, 1, S)).copy()
    ref = np.asarray(jm(jm.params, jm.get_input_embeddings(
        jm.params, jnp.asarray(IDS)), None, jnp.asarray(pos))[0][0])
    got = _logits(tm, IDS)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    mx = load_model_from_weights(cfg, dict(w), torch.float32, "cpu")
    mlp = mx.params["language_model"]["model"]["layers"]["mlp"]
    experts, router = (mlp["experts"]["down_proj"]["weight"],
                       mlp["gate"]["weight"])
    assert isinstance(experts, tq.QuantizedTensor) and experts.bits == 4
    assert tuple(experts.shape) == (2, 4, 128, 64)
    if mode == "exact":
        assert isinstance(router, tq.QuantizedTensor) and router.bits == 8
    else:
        assert isinstance(router, tq.ChannelQuantizedTensor)
        assert router.src_bits == 8
    if kind == "qwen2_moe":
        sg = mlp["shared_expert_gate"]["weight"]
        assert getattr(sg, "bits", getattr(sg, "src_bits", None)) == 8
    mgot = _logits(mx, IDS)[0].numpy()
    if mode == "exact":
        np.testing.assert_allclose(mgot, got, rtol=1e-3, atol=1e-3)
    err, tol, margin_ok, same = bench_rule(got, mgot)
    assert err <= tol and np.all(same[margin_ok])


# ------------------------------------------------------------ route rules


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N,K", [(1, 2048), (8, 4096), (16, 4096),
                                 (40, 1536), (60, 2048), (64, 2048),
                                 (128, 2048)])
def test_router_widths_take_k5(N, K, bits):
    """The exact mode's routers (N = 8, 16, 40, 60, 64, 128 of the six
    families) and Qwen1.5-MoE's shared-expert gate (N = 1) are 2-D triples
    that K5's rule takes, with a GEMV plan for decode and a GEMM plan for a
    512-row chunk; K5's wrapper on the CPU (its plain version) equals the
    dequantized product at N = 1 too."""
    rng = np.random.default_rng(N + K + bits)
    _, t = _quantized(rng.standard_normal((N, K)).astype(np.float32) * 0.1,
                      bits, 64)
    assert tq.qmm_kernel_route(t)
    rt, chunks = k5.qmatmul_gemv_plan(1, K, N, bits, 64)
    assert rt >= 1 and chunks >= 1
    bm, splits = k5.qmatmul_plan(512, K, N, 64, bits)
    assert bm in (64, 128) and splits >= 1
    x = torch.from_numpy(rng.standard_normal((3, K)).astype(np.float32))
    got = tq.quantized_matmul(x, t)
    want = x.double() @ tq.dequantize(t, torch.float64).T
    assert got.shape == (3, N)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("D,I,g", [(2048, 1408, 64), (2048, 1408, 128),
                                   (4096, 14336, 64), (2048, 1024, 32),
                                   (4096, 6400, 128), (1536, 512, 64),
                                   (2048, 768, 128)])
def test_family_expert_stacks_take_the_expert_entry(D, I, g):
    """Every family's gate / up [E, I, D] and down [E, D, I] at 4 and 8
    bits and groups of 32 / 64 / 128 take K5's expert-indexed entry (so the
    card's routes run them); where K5's 2-D rule refuses a down slice (4
    bits, an odd number of groups a row: Qwen1.5-MoE's K = 1408 at g =
    128), the prefill route takes the entry for it."""
    for bits in (4, 8):
        for N, K in ((I, D), (D, I)):
            t = tq.QuantizedTensor(
                q=torch.zeros((4, N, K * bits // 8), dtype=torch.uint8),
                scales=torch.zeros((4, N, K // g)),
                biases=torch.zeros((4, N, K // g)), bits=bits, group_size=g,
                out_dtype="bfloat16")
            assert k5.experts_kernel_route(t)
            odd = bits == 4 and (K // g) % 2 == 1
            assert tq.qmm_kernel_route(t.layer(0)) == (not odd)


def test_prefill_route_runs_odd_group_slices_on_the_expert_entry(
        monkeypatch):
    """A 4-bit down stack of 3 groups of 128 a row: the grouped route sends
    each expert's rows through `quantized_matmul_experts` (every row on
    that expert) instead of the 2-D route K5 refuses, and matches the
    masked scan."""
    E, D, I, k, N = 4, 128, 384, 2, 80
    rng = np.random.default_rng(30)
    stacks = _stacks(E, I, D, 31)
    gate, up = (_quantized(w, 4, 64)[1] for w in stacks[:2])
    down = _quantized(stacks[2], 4, 128)[1]  # [E, D, I]: 3 groups a row
    assert not tq.qmm_kernel_route(down.layer(0))
    calls = []
    real = k5.quantized_matmul_experts

    def spy(x, t, experts, rows=None):
        calls.append((t.shape, experts.unique().tolist()))
        return real(x, t, experts, rows)

    monkeypatch.setattr(k5, "quantized_matmul_experts", spy)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    idx = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                     for _ in range(N)]))
    wts = torch.softmax(torch.randn((N, k)), -1)
    got = moe.grouped_route(x, (gate, up), down, idx, wts, moe._silu_glu)
    ref = moe.switch_glu_scan(x, gate, up, down, idx, wts)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert sorted(e for _, (e,) in calls) == sorted(set(idx.flatten()
                                                        .tolist()))
    assert all(shape == tuple(down.shape) for shape, _ in calls)


# ------------------------------------------------------------ end to end

SPECIALS = {"<|im_start|>": 256, "<|im_end|>": 257, "<|endoftext|>": 258}


@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    """(JAX model, port model, processor): a tiny qwen3_moe checkpoint on
    disk through both packages' `load_model`, and the port's processor
    over a byte tokenizer, which both packages take."""
    from mlx_vlm_tpu.utils.loader import load_model as jax_load_model

    from mlx_vlm_tpu_torch.utils.loader import load_model, write_safetensors
    from mlx_vlm_tpu_torch.utils.processing import processor_for
    from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

    d = tmp_path_factory.mktemp("tiny_qwen3_moe")
    cfg = tiny_moe_text_config("qwen3_moe", vocab_size=320, eos_token_id=257)
    write_safetensors(d / "model.safetensors",
                      moe_text_hf_weights(cfg, seed=11, scale=0.5))
    (d / "config.json").write_text(json.dumps(cfg))
    tm = load_model(d, dtype=torch.float32, device="cpu")
    return (jax_load_model(d, dtype=jnp.float32), tm,
            processor_for(ByteTokenizer(SPECIALS), tm))


def test_generate_batch_admission_and_server_match_jax(on_disk):
    """Greedy stream_generate; batch_generate of three prompts in two slots
    (the third admitted when a slot frees) and a BatchGenerator with two
    prompts admitted together, each row decoding its prompt's tokens
    alone; one served chat: the port's tokens are the JAX package's."""
    from mlx_vlm_tpu.generate.batch import batch_generate as jbatch

    from mlx_vlm_tpu_torch.generate.batch import (BatchGenerator,
                                                  BatchRequest,
                                                  batch_generate)
    from mlx_vlm_tpu_torch.generate.common import embed_prompt

    jm, tm, proc = on_disk
    assert type(tm).__module__ == "mlx_vlm_tpu_torch.models.qwen2_moe." \
                                  "qwen2_moe"
    texts = ["Describe a cat.", "What is a mat?", "Hello there."]
    prompts = [mlx_vlm_tpu_torch.apply_chat_template(proc, tm.config_dict, t)
               for t in texts]
    jt = [r.token for r in mlx_vlm_tpu.stream_generate(
        jm, proc, prompts[0], max_tokens=8)]
    tt = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
        tm, proc, prompts[0], max_tokens=8)]
    assert tt == jt and len(tt) == 8
    ref = jbatch(jm, proc, prompts, max_tokens=6, num_slots=2, capacity=256)
    got = batch_generate(tm, proc, prompts, max_tokens=6, num_slots=2,
                         capacity=256)
    assert got.texts == ref.texts
    inputs = [embed_prompt(tm, {"input_ids": np.asarray(
        proc.tokenizer.encode(p))[None]}) for p in prompts[1:]]
    gen = BatchGenerator(tm, num_slots=2, capacity=128, dtype=torch.float32)
    for u, (e, p, d) in enumerate(inputs):
        gen.insert(BatchRequest(uid=u, inputs_embeds=e, max_tokens=5,
                                position_ids=p, rope_delta=int(d[0, 0])))
    out = {0: [], 1: []}
    while gen.num_active or gen.queue:
        for uid, pairs in gen.next().items():
            out[uid].extend(t for t, _ in pairs)
    assert gen.stats["admissions"] == 1
    for u, (e, p, d) in enumerate(inputs):
        alone = [int(t[0]) for t, _ in ar.generate_step(
            e, tm, position_ids=p, rope_deltas=d, max_tokens=5)]
        assert out[u] == alone
    body = {"messages": [{"role": "user", "content": "Describe a cat."}],
            "max_tokens": 6}
    served = serve_chats([("jax", jm, proc), ("port", tm, proc)], [body],
                         "tiny-qwen3-moe")
    assert (served["port"][0]["choices"][0]["message"]["content"]
            == served["jax"][0]["choices"][0]["message"]["content"])
    assert served["port"][0]["usage"] == served["jax"][0]["usage"]
