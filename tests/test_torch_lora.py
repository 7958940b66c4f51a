"""Port parity: LoRA / DoRA adapters (core/layers.py `linear`,
trainer/lora.py) and `StoppingCriteria` (core/stopping.py) against the
JAX package, in float32 on the CPU on numpy-seeded inputs.

- `linear` with LoRA and DoRA factors on dense, exact (mlx group-affine
  QuantizedTensor) and w8chan (per-channel int8) bases, per layer and
  stacked [L, ...] (sliced by `layer_view`): within 1e-5 of max|ref|.
  DoRA on a w8chan base is held to the port's DoRA on the dequantized
  weight (the reference's DoRA takes no per-channel base: it raises);
- an adapter written by the JAX package's `save_adapter` and read by the
  port's `apply_lora_layers` gives the JAX package's logits on the tiny
  llama (LoRA and DoRA) within 1e-4, its tree equal to the JAX package's
  carried over by `params_from_jax`; `fuse_lora` / `fuse_dora` equal the
  JAX package's within 1e-6;
- fault 3 (ROADMAP Queue 3): on a w4grp Qwen2-VL whose decode step takes
  the fused route (K3), the JAX package's decode step ignores an attached
  LoRA while its prefill applies it; the port turns the fused route off
  when factors are attached, so its decode step sees the adapter and
  agrees with its prefill;
- `StoppingCriteria`: equal case by case to the JAX class.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.core import layers as jlayers
from mlx_vlm_tpu.core import quant as jquant
from mlx_vlm_tpu.core.stopping import StoppingCriteria as JaxStopping
from mlx_vlm_tpu.trainer import lora as jlora
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import llama_hf_weights as jax_llama_weights
from mlx_vlm_tpu_torch.core import layers as tlayers
from mlx_vlm_tpu_torch.core.quant import (ChannelQuantizedTensor,
                                          QuantizedTensor)
from mlx_vlm_tpu_torch.core.stopping import StoppingCriteria
from mlx_vlm_tpu_torch.models.base import layer_view
from mlx_vlm_tpu_torch.trainer import lora as tlora
from mlx_vlm_tpu_torch.utils.loader import (decide_fused_decode,
                                            load_model_from_weights,
                                            params_from_jax)
from mlx_vlm_tpu_torch.utils.testing import tiny_llama_config
from test_torch_qwen2_5_vl import tree_equal

torch.set_num_threads(2)


def port_tree(v):
    """A JAX-package tree (numpy leaves) as the port's."""
    if isinstance(v, dict):
        return {k: port_tree(x) for k, x in v.items()}
    if hasattr(v, "q8"):
        return ChannelQuantizedTensor(
            q8=torch.from_numpy(np.asarray(v.q8).copy()),
            scales=torch.from_numpy(np.asarray(v.scales).copy()),
            biases=torch.from_numpy(np.asarray(v.biases).copy()),
            src_bits=int(v.src_bits), out_dtype=str(v.out_dtype))
    if hasattr(v, "group_size"):
        return QuantizedTensor(
            q=torch.from_numpy(np.asarray(v.q).copy()),
            scales=torch.from_numpy(np.asarray(v.scales).copy()),
            biases=torch.from_numpy(np.asarray(v.biases).copy()),
            bits=int(v.bits), group_size=int(v.group_size),
            out_dtype=str(v.out_dtype))
    return torch.from_numpy(np.asarray(v).copy())


def _jax_base(kind, w):
    if kind == "dense":
        return jnp.asarray(w)
    qt = jquant.quantize(jnp.asarray(w), bits=4, group_size=32)
    if kind == "exact":
        return qt
    return jquant.to_channel_quantized(qt)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kind", ["dense", "exact", "w8chan"])
@pytest.mark.parametrize("adapter", ["lora", "dora"])
def test_linear_with_adapters_matches_reference(adapter, kind, stacked):
    rng = np.random.default_rng(1)
    L, O, I, r = 2, 48, 64, 4
    lead = (L,) if stacked else ()
    w = rng.standard_normal((*lead, O, I)).astype(np.float32) * 0.1
    p = {"weight": _jax_base(kind, w),
         "bias": rng.standard_normal((*lead, O)).astype(np.float32),
         "lora_a": rng.standard_normal((*lead, r, I)).astype(np.float32),
         "lora_b": rng.standard_normal((*lead, O, r)).astype(np.float32)
         * 0.1}
    if adapter == "dora":
        p["dora_m"] = (1 + 0.1 * rng.standard_normal((*lead, O))).astype(
            np.float32)
    x = rng.standard_normal((3, 5, I)).astype(np.float32)
    tp = port_tree(jax.tree_util.tree_map(np.asarray, p))
    for i in range(L if stacked else 1):
        jp = jax.tree_util.tree_map(lambda a: a[i], p) if stacked else p
        tpi = layer_view(tp, i) if stacked else tp
        got = tlayers.linear(tpi, torch.from_numpy(x)).numpy()
        if adapter == "dora" and kind == "w8chan":
            with pytest.raises(Exception):
                jlayers.linear(jp, jnp.asarray(x))
            dense = dict(tpi, weight=tlayers.dense_weight(tpi["weight"]))
            ref = tlayers.linear(dense, torch.from_numpy(x)).numpy()
        else:
            ref = np.asarray(jlayers.linear(jp, jnp.asarray(x)))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        base = tlayers.linear({"weight": tpi["weight"], "bias": tpi["bias"]},
                              torch.from_numpy(x)).numpy()
        assert np.abs(got - base).max() > 1e-2 * np.abs(base).max()


def _adapter(params, rank, seed, dora):
    """A JAX-package adapter on q_proj / v_proj with nonzero factors."""
    lora = (jlora.init_dora if dora else jlora.init_lora)(
        params, rank=rank, targets=("q_proj", "v_proj"), seed=seed)
    rng = np.random.default_rng(seed)
    for fac in lora.values():
        fac["lora_b"] = jnp.asarray(rng.standard_normal(
            fac["lora_b"].shape).astype(np.float32) * 0.1)
        if dora:
            fac["dora_m"] = fac["dora_m"] * 1.1
    return lora


@pytest.mark.parametrize("dora", [False, True])
def test_adapter_round_trip_gives_reference_logits(tmp_path, dora):
    cfg = tiny_llama_config()
    w = jax_llama_weights(cfg, seed=2)
    jm = jax_load(dict(cfg), dict(w), jnp.float32)
    tm = load_model_from_weights(cfg, dict(w), torch.float32, "cpu")
    lora = _adapter(jm.params, 4, 3, dora)
    jlora.save_adapter(str(tmp_path), lora, {"rank": 4})
    jm.params = jlora.attach_lora(jm.params, lora)
    tlora.apply_lora_layers(tm, str(tmp_path))
    q = tm.params["language_model"]["model"]["layers"]["self_attn"]["q_proj"]
    assert q["lora_a"].shape == (2, 4, 64) and q["lora_a"].dtype == \
        torch.float32
    ids = (np.arange(9) * 11 % 200)[None]
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (3, 1, 9)).copy()
    ref = np.asarray(jm(jm.params, jm.get_input_embeddings(
        jm.params, jnp.asarray(ids)), None, jnp.asarray(pos))[0])
    got = tm(tm.params, tm.get_input_embeddings(
        tm.params, torch.from_numpy(ids)), None, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))


@pytest.mark.parametrize("dora", [False, True])
def test_fuse_matches_reference(dora):
    cfg = tiny_llama_config()
    jm = jax_load(dict(cfg), jax_llama_weights(cfg, seed=4), jnp.float32)
    lora = _adapter(jm.params, 2, 5, dora)
    fuse = jlora.fuse_dora if dora else jlora.fuse_lora
    ref = fuse(jm.params, lora)
    tparams = port_tree(jax.tree_util.tree_map(np.asarray, jm.params))
    tfac = port_tree(jax.tree_util.tree_map(np.asarray, lora))
    got = (tlora.fuse_dora if dora else tlora.fuse_lora)(tparams, tfac)
    for path in lora:
        node_r, node_g = ref, got
        for part in path.split("."):
            node_r, node_g = node_r[part], node_g[part]
        np.testing.assert_allclose(node_g["weight"].numpy(),
                                   np.asarray(node_r["weight"]), rtol=0,
                                   atol=1e-6)
    assert tlora.has_adapters(tlora.attach_lora(tparams, tfac))
    assert not tlora.has_adapters(got)


def test_adapter_turns_the_fused_route_off():
    """Fault 3 (ROADMAP Queue 3) on the JAX package's fused-head test
    model (w4grp, 2 layers): its decode step, on the fused route, gives
    the same logits with and without an attached LoRA, though its prefill
    differs; the port's route is off with the factors attached, and its
    decode step equals its uncached forward's last row."""
    from mlx_vlm_tpu.utils.loader import ensure_layer_params
    from test_torch_fused_decode import _models

    jm, tm, cfg = _models(2, seed=13)
    assert decide_fused_decode(tm)
    ensure_layer_params(jm)
    lora = _adapter(jm.params, 4, 6, False)
    base = dict(jm.params)
    ids = (np.arange(6) * 13 % 150)[None]
    S = ids.shape[1]

    def pos(n, start=0):
        return np.broadcast_to(np.arange(start, start + n, dtype=np.int32),
                               (3, 1, n)).copy()

    def prefill(params):
        jm.params = params
        e = jm.get_input_embeddings(params, jnp.asarray(ids))
        cache = jm.language_model.init_cache(1, 32, jnp.float32)
        pre, cache = jm(params, e[:, :-1], cache, jnp.asarray(pos(S - 1)))
        return np.asarray(pre)[0], cache, e

    def step(params, cache, e):
        jm.params = params
        out, _ = jm(params, e[:, -1:], cache, jnp.asarray(pos(1, S - 1)))
        return np.asarray(out)[0, -1]

    adapted = jlora.attach_lora(base, lora)
    pre0, cache0, e = prefill(base)
    pre1, _, _ = prefill(adapted)
    assert np.abs(pre1 - pre0).max() > 1e-3
    # one cache, the base prefill's: the fused step does not see the LoRA
    step0 = step(base, cache0, e)
    np.testing.assert_allclose(step(adapted, cache0, e), step0, rtol=1e-5,
                               atol=1e-5)

    tfac = port_tree(jax.tree_util.tree_map(np.asarray, lora))
    tm.params = tlora.attach_lora(tm.params, tfac)
    assert not decide_fused_decode(tm) and not tm.language_model.fused_decode
    e = tm.get_input_embeddings(tm.params, torch.from_numpy(ids))
    cache = tm.language_model.init_cache(1, 32, torch.float32)
    tm(tm.params, e[:, :-1], cache, torch.from_numpy(pos(S - 1)))
    step = tm(tm.params, e[:, -1:], cache, torch.from_numpy(pos(1, S - 1)))
    full = tm(tm.params, e, None, torch.from_numpy(pos(S)))
    np.testing.assert_allclose(step[0, -1].numpy(), full[0, -1].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert np.abs(step[0, -1].numpy() - step0).max() > 1e-3


class _Tok:
    def encode(self, text, add_special_tokens=False):
        return [ord(c) for c in text]


@pytest.mark.parametrize("case", range(5))
def test_stopping_criteria_equals_reference(case):
    args = [((1, 2), ("END",), None), ((), ("ab", "xyz"), None),
            ((7,), (), _Tok()), ((3,), ("stop",), _Tok()),
            ((), (), None)][case]
    feeds = ["he", "llo E", "ND", "xa", "b", "  x", "yz", "s", "top"]
    extra = ["!", "<eot>", 9, "q"]
    ref, got = JaxStopping(*args), StoppingCriteria(*args)
    for t in extra:
        ref.add_eos_token(t)
        got.add_eos_token(t)
    assert got.eos_ids == ref.eos_ids and got.stop_words == ref.stop_words
    for i in range(12):
        assert got.is_eos(i) == ref.is_eos(i)
    for f in feeds:
        assert got.check_text(f) == ref.check_text(f)
        assert got._tail == ref._tail
    ref.reset()
    got.reset()
    assert got._tail == ref._tail == ""
