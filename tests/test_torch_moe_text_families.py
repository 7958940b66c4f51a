"""Port parity: the text MoE decoders (models/qwen2_moe, which qwen3_moe
loads as, models/mixtral, olmoe, phimoe and granitemoe) against the JAX
package, both in float32 on the CPU on the same numpy-seeded weights, at
the JAX package's Qwen-MoE test size (hidden 64, 2 decoder layers, 4 / 2
heads, 4 experts of width 32, 2 a token; `tiny_moe_text_config`):

- host layouts: each published config parsed as the JAX package parses
  it, the loader's model-type dispatch, the weight draws and `sanitize`
  key for key on the HF layout;
- each type's teacher-forced logits (a cached prefill, then decode steps
  on the JAX package's greedy tokens) within 1e-3 and by bench.py's rule,
  `forward_captured`'s per-layer hidden states within 1e-4, and greedy
  tokens equal to the JAX package's `generate_step`;
- the mlx `switch_mlp` layout against the HF per-expert layout (the same
  arrays): equal logits, and the JAX package's failure on the former
  (ROADMAP Queue 3);
- granitemoe's split of a quantized `input_linear` triple (numpy codes,
  bf16 tensor scales and biases), an 8-bit router under mixtral's and
  granitemoe's checkpoint names in w8chan and exact (the JAX package's
  load misreads it, ROADMAP Queue 3), and granitemoe's head size 64 on
  the prefill and decode attention routes.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.generate.ar import generate_step as jax_generate_step
from mlx_vlm_tpu.utils.loader import get_model_and_args as jax_model_and_args
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import qwen2_moe_hf_weights as jax_hf_weights
from mlx_vlm_tpu.utils.testing import tiny_qwen2_moe_config as jax_tiny_config
from mlx_vlm_tpu_torch.core.quant import (ChannelQuantizedTensor,
                                          QuantizedTensor, dequantize,
                                          from_mlx_packed)
from mlx_vlm_tpu_torch.generate import ar
from mlx_vlm_tpu_torch.models.granitemoe.granitemoe import split_halves
from mlx_vlm_tpu_torch.utils.loader import (get_model_and_args,
                                            load_model_from_weights,
                                            params_from_jax)
from mlx_vlm_tpu_torch.utils.testing import (MOE_TEXT_TYPES,
                                             granite_3_0_3b_a800m_config,
                                             mixtral_8x7b_config,
                                             mlx_quantized_checkpoint,
                                             moe_text_hf_weights,
                                             olmoe_1b_7b_config,
                                             phi_3_5_moe_config,
                                             qwen1_5_moe_a2_7b_config,
                                             qwen2_moe_hf_weights,
                                             qwen3_30b_a3b_config,
                                             tiny_moe_text_config,
                                             tiny_qwen2_moe_config)
from test_torch_qwen2_5_vl import bench_rule, jax_leaf, tree_equal

torch.set_num_threads(2)

PUBLISHED = {"qwen3_moe": qwen3_30b_a3b_config,
             "qwen2_moe": qwen1_5_moe_a2_7b_config,
             "mixtral": mixtral_8x7b_config, "olmoe": olmoe_1b_7b_config,
             "phimoe": phi_3_5_moe_config,
             "granitemoe": granite_3_0_3b_a800m_config}
# (model type, the package the loader picks)
PACKAGES = {"qwen2_moe": "qwen2_moe", "qwen3_moe": "qwen2_moe",
            "mixtral": "mixtral", "olmoe": "olmoe", "phimoe": "phimoe",
            "granitemoe": "granitemoe"}


@pytest.fixture(scope="module", params=MOE_TEXT_TYPES)
def pair(request):
    """(JAX model, port model, config) of one type on the same weights."""
    cfg = tiny_moe_text_config(request.param)
    w = moe_text_hf_weights(cfg, seed=3)
    return (jax_load(dict(cfg), dict(w), jnp.float32),
            load_model_from_weights(cfg, dict(w), torch.float32, "cpu"), cfg)


def _positions(S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (3, 1, S)).copy()


def _logits(tm, ids):
    e = tm.get_input_embeddings(tm.params, torch.from_numpy(ids))
    return tm(tm.params, e, None,
              torch.from_numpy(_positions(ids.shape[1]).astype(np.int64)))


def _jax_logits(jm, ids):
    e = jm.get_input_embeddings(jm.params, jnp.asarray(ids))
    return np.asarray(jm(jm.params, e, None,
                         jnp.asarray(_positions(ids.shape[1])))[0])


IDS = (np.arange(3, 13, dtype=np.int64) * 7 % 200)[None]


# ------------------------------------------------------------ host layouts


@pytest.mark.parametrize("kind", MOE_TEXT_TYPES)
def test_published_config_parses_as_the_reference(kind):
    d = PUBLISHED[kind]()
    assert d["model_type"] == kind
    arch, as_type = get_model_and_args(d)
    jarch, jtype = jax_model_and_args(d)
    assert as_type == jtype == PACKAGES[kind]
    assert arch.__name__ == f"mlx_vlm_tpu_torch.models.{PACKAGES[kind]}"
    assert jarch.__name__ == f"mlx_vlm_tpu.models.{PACKAGES[kind]}"
    got = arch.ModelConfig.from_dict(json.loads(json.dumps(d)))
    ref = jarch.ModelConfig.from_dict(json.loads(json.dumps(d)))
    assert got.__dict__ == ref.__dict__
    widths = {"qwen3_moe": (2048, 48, 32, 4, 128, 128, 8),
              "qwen2_moe": (2048, 24, 16, 16, 128, 60, 4),
              "mixtral": (4096, 32, 32, 8, 128, 8, 2),
              "olmoe": (2048, 16, 16, 16, 128, 64, 8),
              "phimoe": (4096, 32, 32, 8, 128, 16, 2),
              "granitemoe": (1536, 32, 24, 8, 64, 40, 8)}[kind]
    assert (got.hidden_size, got.num_hidden_layers, got.num_attention_heads,
            got.num_key_value_heads, got.head_dim, got.num_experts,
            got.num_experts_per_tok) == widths


def test_tiny_config_and_weights_equal_reference():
    cfg = tiny_qwen2_moe_config()
    assert cfg == jax_tiny_config()
    ref, got = jax_hf_weights(cfg, 3), qwen2_moe_hf_weights(cfg, 3)
    assert list(got) == list(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)


@pytest.mark.parametrize("kind", MOE_TEXT_TYPES)
def test_sanitize_equals_reference_on_the_hf_layout(kind):
    cfg = tiny_moe_text_config(kind)
    w = moe_text_hf_weights(cfg, seed=4)
    w["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(4)
    arch, _ = get_model_and_args(cfg)
    jarch, _ = jax_model_and_args(cfg)
    a, b = arch.Model.sanitize(dict(w)), jarch.Model.sanitize(dict(w))
    assert list(a) == list(b)
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in b)
    assert all(k.startswith("language_model.") for k in a)


# ------------------------------------------------------------ float paths


def test_teacher_forced_logits_and_hidden_states(pair):
    """A cached prefill through `forward_captured` (every layer's hidden
    state within 1e-4), then 4 decode steps on the JAX package's greedy
    tokens: the logits within 1e-3 and by bench.py's rule."""
    jm, tm, _ = pair
    jlm, tlm = jm.language_model, tm.language_model
    jp, tp = jm.params["language_model"], tm.params["language_model"]
    S = IDS.shape[1]
    je = jm.get_input_embeddings(jm.params, jnp.asarray(IDS))
    te = tm.get_input_embeddings(tm.params, torch.from_numpy(IDS))
    jc = jlm.init_cache(1, 32, jnp.float32)
    tc = tlm.init_cache(1, 32, torch.float32)
    pos = _positions(S)
    jh, jc, jhid = jlm.forward_captured(jp, je, jc, jnp.asarray(pos))
    th, thid = tlm.forward_captured(tp, te, tc,
                                    torch.from_numpy(pos.astype(np.int64)))
    assert thid.shape == (2, 1, S, 64)
    np.testing.assert_allclose(thid.numpy(), np.asarray(jhid), rtol=1e-4,
                               atol=1e-4)
    ref = [np.asarray(jlm.logits(jp, jh))[0, -1]]
    got = [tlm.logits(tp, th)[0, -1].numpy()]
    for _ in range(4):
        tok = np.array([[int(np.argmax(ref[-1]))]])
        p = int(jc.offset)
        jl, jc = jm(jm.params, jm.get_input_embeddings(
            jm.params, jnp.asarray(tok)), jc, jnp.full((3, 1, 1), p,
                                                        jnp.int32))
        ref.append(np.asarray(jl)[0, 0])
        got.append(tm(tm.params, tm.get_input_embeddings(
            tm.params, torch.from_numpy(tok)), tc,
            torch.full((3, 1, 1), p))[0, 0].numpy())
    assert int(tc.offset) == int(jc.offset) == S + 4
    ref, got = np.stack(ref), np.stack(got)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])


def test_greedy_tokens_match_generate_step(pair):
    jm, tm, _ = pair
    je = jax.jit(jm.get_input_embeddings)(jm.params, jnp.asarray(IDS))
    want = [int(t[0]) for t, _ in jax_generate_step(je, jm, max_tokens=8)]
    te = tm.get_input_embeddings(tm.params, torch.from_numpy(IDS))
    got = [int(t[0]) for t, _ in ar.generate_step(te, tm, max_tokens=8)]
    assert got == want and len(got) == 8


def test_params_carry_over_from_jax(pair):
    jm, tm, _ = pair
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))


# ------------------------------------------------------------ layouts


@pytest.mark.parametrize("kind", MOE_TEXT_TYPES)
def test_mlx_and_hf_layouts_agree(kind):
    """The same arrays in the mlx `switch_mlp` layout and in the HF one
    load to the same stacked experts [L, E, ...] and give equal logits."""
    cfg = tiny_moe_text_config(kind)
    hf, mlx = (load_model_from_weights(
        cfg, moe_text_hf_weights(cfg, seed=5, layout=layout),
        torch.float32, "cpu") for layout in ("hf", "mlx"))
    tree_equal(hf.params, mlx.params)
    experts = mlx.params["language_model"]["model"]["layers"]["mlp"][
        "experts"]
    assert experts["gate_proj"]["weight"].shape == (2, 4, 32, 64)
    assert experts["down_proj"]["weight"].shape == (2, 4, 64, 32)
    np.testing.assert_array_equal(_logits(hf, IDS).numpy(),
                                  _logits(mlx, IDS).numpy())


def test_reference_misses_the_mlx_layout():
    """Divergence (ROADMAP Queue 3): the JAX package's `sanitize` keeps
    `mlp.switch_mlp.*`, so its decoder, which reads `mlp.experts`, fails
    at the first forward on an mlx conversion; the port renames the
    stacks and runs it."""
    cfg = tiny_moe_text_config("qwen3_moe")
    w = moe_text_hf_weights(cfg, seed=5, layout="mlx")
    jm = jax_load(dict(cfg), dict(w), jnp.float32)
    assert "switch_mlp" in jm.params["language_model"]["model"]["layers"][
        "mlp"]
    with pytest.raises(KeyError, match="experts"):
        _jax_logits(jm, IDS)
    tm = load_model_from_weights(cfg, dict(w), torch.float32, "cpu")
    assert np.all(np.isfinite(_logits(tm, IDS).numpy()))


def _quantized_config(kind):
    """The tiny type at widths that take groups of 64."""
    return tiny_moe_text_config(kind, hidden_size=128,
                                moe_intermediate_size=64, head_dim=32,
                                intermediate_size=256)


def test_granite_split_of_a_quantized_triple():
    """`input_linear` [E, 2I, D] as an mlx triple (uint32 numpy codes, bf16
    tensor scales and biases) splits along the out axis into gate / up
    triples that dequantize to the halves of the whole."""
    _, w = mlx_quantized_checkpoint(_quantized_config("granitemoe"),
                                    seed=6)
    p = "model.layers.0.block_sparse_moe."
    fused = {f: (np.concatenate([w[p + f"switch_mlp.gate_proj.{f}"],
                                 w[p + f"switch_mlp.up_proj.{f}"]], 1)
                 if f == "weight" else
                 torch.cat([w[p + f"switch_mlp.gate_proj.{f}"],
                            w[p + f"switch_mlp.up_proj.{f}"]], 1))
             for f in ("weight", "scales", "biases")}
    assert isinstance(fused["scales"], torch.Tensor)
    from mlx_vlm_tpu_torch.models.granitemoe import Model

    out = Model.sanitize({p + f"input_linear.{f}": v
                          for f, v in fused.items()})
    whole = dequantize(from_mlx_packed(fused["weight"], fused["scales"],
                                       fused["biases"], 4, 64), torch.float32)
    I = whole.shape[1] // 2
    for half, name in ((slice(0, I), "gate_proj"), (slice(I, None),
                                                     "up_proj")):
        base = f"language_model.{p.replace('block_sparse_moe.', 'mlp.')}" \
               f"experts.{name}."
        trip = [out[base + f] for f in ("weight", "scales", "biases")]
        assert all(t.flags["C_CONTIGUOUS"] if isinstance(t, np.ndarray)
                   else t.is_contiguous() for t in trip)
        got = dequantize(from_mlx_packed(*trip, 4, 64), torch.float32)
        assert torch.equal(got, whole[:, half])
    for v in fused.values():  # the numpy and the tensor splits alike
        a, b = split_halves(v)
        assert a.shape == b.shape == (v.shape[0], v.shape[1] // 2,
                                      v.shape[2])


def _per_expert_layout(kind, w):
    """An mlx checkpoint's stacked expert triples in the family's HF layout
    (one triple an expert; granitemoe's fused input_linear), for the JAX
    package, which loads no other."""
    out = {}
    for k, v in w.items():
        if ".switch_mlp." not in k:
            out[k] = v
            continue
        base, field = k.rsplit(".", 1)
        pre, name = base.split("switch_mlp.")
        if kind == "granitemoe":
            if name == "down_proj":
                out[pre + f"output_linear.{field}"] = v
            elif name == "gate_proj":
                up = w[k.replace("gate_proj", "up_proj")]
                out[pre + f"input_linear.{field}"] = (
                    np.concatenate([v, up], 1) if isinstance(v, np.ndarray)
                    else torch.cat([v, up], 1))
            continue
        n = ({"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}[name]
             if pre.endswith("block_sparse_moe.") else name)
        for e in range(v.shape[0]):
            out[pre + f"experts.{e}.{n}.{field}"] = v[e]
    return out


@pytest.mark.parametrize("mode", [None, "exact"])
@pytest.mark.parametrize("kind", ["mixtral", "granitemoe"])
def test_renamed_router_keeps_its_bits(monkeypatch, kind, mode):
    """An 8-bit router under the checkpoint's own name
    (`block_sparse_moe.gate`, `block_sparse_moe.router.layer`) beside 4-bit
    linears and experts: the port folds it at 8 bits (per-channel int8 from
    8 bits by default, K5's 8-bit codes in exact), and its logits equal
    those of the float model of the dequantized weights (exact) or agree
    by bench.py's rule (w8chan).  Divergence (ROADMAP Queue 3): the JAX
    package probes the renamed key alone and takes the 8-bit codes for
    4-bit ones: its exact load keeps them as a 4-bit triple, its default
    load fails (the requantization's shapes do not broadcast)."""
    if mode:
        monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", mode)
    else:
        monkeypatch.delenv("MLX_VLM_TPU_RUNTIME_QUANT", raising=False)
    cfg, w = mlx_quantized_checkpoint(_quantized_config(kind), seed=8,
                                      router_bits=8)
    name = "gate" if kind == "mixtral" else "router.layer"
    assert cfg["quantization"][f"model.layers.1.block_sparse_moe.{name}"][
        "bits"] == 8
    tm = load_model_from_weights(cfg, dict(w), torch.float32, "cpu")
    mlp = tm.params["language_model"]["model"]["layers"]["mlp"]
    router, experts = mlp["gate"]["weight"], mlp["experts"]["up_proj"][
        "weight"]
    assert isinstance(experts, QuantizedTensor) and experts.bits == 4
    if mode == "exact":
        assert isinstance(router, QuantizedTensor) and router.bits == 8
    else:
        assert isinstance(router, ChannelQuantizedTensor)
        assert router.src_bits == 8
    # the float model of the same dequantized weights
    dense = {}
    for k, v in w.items():
        if k.endswith((".scales", ".biases")) and k.rsplit(".", 1)[0] \
                + ".weight" in w:
            continue
        if isinstance(v, np.ndarray) and v.dtype == np.uint32:
            base = k[: -len(".weight")]
            entry = cfg["quantization"].get(base, {})
            dense[k] = dequantize(from_mlx_packed(
                v, w[base + ".scales"], w[base + ".biases"],
                entry.get("bits", 4), 64), torch.float32).numpy()
        else:
            dense[k] = v.float().numpy()
    fcfg = {k: v for k, v in cfg.items() if k != "quantization"}
    ref = _logits(load_model_from_weights(fcfg, dense, torch.float32, "cpu"),
                  IDS)[0].numpy()
    got = _logits(tm, IDS)[0].numpy()
    if mode == "exact":
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])
    ref_weights = {k: jax_leaf(v) for k, v in
                   _per_expert_layout(kind, w).items()}
    if mode == "exact":  # the 8-bit codes kept as a 4-bit triple
        jm = jax_load(dict(cfg), ref_weights, jnp.float32)
        jr = jm.params["language_model"]["model"]["layers"]["mlp"]["gate"][
            "weight"]
        assert jr.bits == 4
    else:  # their per-channel requantization fails on the group count
        with pytest.raises(ValueError, match="broadcast"):
            jax_load(dict(cfg), ref_weights, jnp.float32)


# ------------------------------------------------------------ routes


def test_granite_head_size_64_routes():
    """Granite 3.0's heads of 64: a prefill chunk that passes K4's other
    conditions (256 rows against 8192 slots) takes `sdpa` (K4 takes 128
    only, `flash_eligible` decides by shape), which runs here and matches
    the uncached forward within 1e-4; a 4-bit cache's decode step takes
    K6, whose rule wants a multiple of 8."""
    from types import SimpleNamespace

    from mlx_vlm_tpu_torch.core import cache as tcache

    cfg = granite_3_0_3b_a800m_config()
    D = cfg["hidden_size"] // cfg["num_attention_heads"]

    def on_cuda(shape):
        return SimpleNamespace(device=SimpleNamespace(type="cuda"),
                               shape=shape)

    assert D == 64
    assert not tcache.flash_eligible(on_cuda((1, 24, 256, D)),
                                     on_cuda((1, 8, 8192, D)))
    assert tcache.flash_eligible(on_cuda((1, 24, 256, 128)),
                                 on_cuda((1, 8, 8192, 128)))
    assert tcache.int4_kv_route(1, D)
    tiny = tiny_moe_text_config("granitemoe", hidden_size=256,
                                num_attention_heads=4, head_dim=64)
    tm = load_model_from_weights(tiny, moe_text_hf_weights(tiny, seed=9),
                                 torch.float32, "cpu")
    ids = (np.arange(256, dtype=np.int64) * 13 % 250)[None]
    e = tm.get_input_embeddings(tm.params, torch.from_numpy(ids))
    pos = torch.from_numpy(_positions(256).astype(np.int64))
    cache = tm.language_model.init_cache(1, 8192, torch.float32)
    cached = tm(tm.params, e, cache, pos)
    np.testing.assert_allclose(cached.numpy(),
                               tm(tm.params, e, None, pos).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_packages_import_no_jax():
    """The five packages import neither JAX nor the JAX package, and no
    module of the port, nor chip_smoke.py, has an import statement of
    either."""
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import mlx_vlm_tpu_torch.models.qwen2_moe, "
            "mlx_vlm_tpu_torch.models.mixtral, mlx_vlm_tpu_torch.models.olmoe, "
            "mlx_vlm_tpu_torch.models.phimoe, "
            "mlx_vlm_tpu_torch.models.granitemoe\n"
            "bad = [m for m in ('jax', 'mlx_vlm_tpu') if m in sys.modules]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(repo),
                         env={**os.environ, "PYTHONPATH": str(repo)},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|mlx_vlm_tpu)(?:\.|\s|$)",
                     re.M)
    files = [*(repo / "mlx_vlm_tpu_torch").rglob("*.py"),
             repo / "chip_smoke.py"]
    assert [f.name for f in files if pat.search(f.read_text())] == []
