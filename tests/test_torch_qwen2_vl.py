"""Port parity: the Qwen2-VL slice end to end.

The JAX package runs its per-linear path (MLX_VLM_TPU_FUSED_DECODE=0) on
w4grp weights built as bench.py's parity gate builds them (hidden 256,
2 layers); the port gets the same parameters through `params_from_jax`.
Vision features and merged embeddings agree at 1e-4; teacher-forced prefill
and 8 decode steps agree under bench.py's rule (logits within
0.05 * max(1, max|ref|), equal argmax wherever the reference's top-1/top-2
margin exceeds twice that).  Both run in float32 on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.core.quant import quantize, to_int4_grouped
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import build_tiny_checkpoint
from mlx_vlm_tpu.utils.testing import qwen2_vl_hf_weights as jax_hf_weights
from mlx_vlm_tpu_torch.core.quant import Int4GroupedTensor
from mlx_vlm_tpu_torch.models.qwen2_vl import Model, ModelConfig
from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights, params_from_jax
from mlx_vlm_tpu_torch.utils.processing import Qwen2VLImageProcessor
from mlx_vlm_tpu_torch.utils.testing import (mlx_int4_checkpoint,
                                             qwen2_vl_hf_weights,
                                             tiny_qwen2_vl_config)

torch.set_num_threads(2)


def _bench_config():
    """bench.py's parity-gate configuration (bench.py:166-173)."""
    cfg = tiny_qwen2_vl_config()
    cfg["hidden_size"] = 256
    cfg["intermediate_size"] = 256
    cfg["num_attention_heads"] = 2
    cfg["num_key_value_heads"] = 2
    cfg["num_hidden_layers"] = 2
    cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [16, 24, 24]}
    cfg["vision_config"]["hidden_size"] = 32
    return cfg


@pytest.fixture(scope="module")
def models():
    """(jax model, port model) on the same w4grp parameters."""
    cfg = _bench_config()
    weights = jax_hf_weights(cfg, seed=0)
    rng = np.random.default_rng(1)
    for k in list(weights.keys()):
        if (k.startswith("model.layers.") and k.endswith(".weight")
                and "layernorm" not in k and weights[k].ndim == 2):
            w = rng.standard_normal(weights[k].shape).astype(np.float32) * 0.1
            weights[k] = to_int4_grouped(
                quantize(jnp.asarray(w), bits=4, group_size=64))
    mp = pytest.MonkeyPatch()
    mp.setenv("MLX_VLM_TPU_FUSED_DECODE", "0")
    try:
        jm = jax_load(dict(cfg), dict(weights), jnp.float32)
    finally:
        mp.undo()
    assert "fused_decode" not in jm.params["language_model"]
    tm = Model(ModelConfig.from_dict(cfg))
    tm.params = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    tm.config_dict = cfg
    tm.device = torch.device("cpu")
    return jm, tm, cfg


def _inputs(cfg):
    """One 56x84 image (6 merged tokens) inside a short token prompt."""
    img = np.random.default_rng(4).integers(0, 256, (56, 84, 3), dtype=np.uint8)
    pix = Qwen2VLImageProcessor()(img)
    n_img = int(np.prod(pix["image_grid_thw"][0])) // 4
    it = cfg["image_token_id"]
    ids = np.array([[5, 6, 7] + [it] * n_img + [8, 9, 10, 11]], np.int64)
    return ids, pix


def test_params_carry_over_unchanged(models):
    jm, tm, _ = models
    jl = jm.params["language_model"]["model"]["layers"]["mlp"]["down_proj"]["weight"]
    tl = tm.params["language_model"]["model"]["layers"]["mlp"]["down_proj"]["weight"]
    assert isinstance(tl, Int4GroupedTensor) and tl.qp.shape[0] == 2
    for f in ("qp", "sl", "sh", "bl", "bh"):
        assert np.array_equal(np.asarray(getattr(jl, f)), getattr(tl, f).numpy())
    je = np.asarray(jm.params["vision_tower"]["blocks"]["attn"]["qkv"]["weight"])
    assert np.array_equal(je, tm.params["vision_tower"]["blocks"]["attn"]["qkv"]
                          ["weight"].numpy())


def test_vision_features_and_merged_embeddings(models):
    jm, tm, cfg = models
    ids, pix = _inputs(cfg)
    aux = tm.vision_aux_inputs(pix["image_grid_thw"])
    jaux = jm.vision_aux_inputs(pix["image_grid_thw"])
    for k in aux:
        assert np.array_equal(aux[k], np.asarray(jaux[k]))
    ref_f = np.asarray(jm.vision_features(
        jm.params, jnp.asarray(pix["pixel_values"]),
        **{k: jnp.asarray(v) for k, v in jaux.items()}))
    got_f = tm.vision_features(
        tm.params, torch.from_numpy(pix["pixel_values"]),
        **{k: torch.from_numpy(v) for k, v in aux.items()}).numpy()
    np.testing.assert_allclose(got_f, ref_f, atol=1e-4, rtol=1e-4)
    ref_e = np.asarray(jm.get_input_embeddings(
        jm.params, jnp.asarray(ids), jnp.asarray(pix["pixel_values"]),
        **{k: jnp.asarray(v) for k, v in jaux.items()}))
    got_e = tm.get_input_embeddings(
        tm.params, torch.from_numpy(ids), torch.from_numpy(pix["pixel_values"]),
        **{k: torch.from_numpy(v) for k, v in aux.items()}).numpy()
    np.testing.assert_allclose(got_e, ref_e, atol=1e-4, rtol=1e-4)


def _jax_steps(jm, ids, pix, n_steps=8, capacity=128):
    aux = {k: jnp.asarray(v) for k, v in
           jm.vision_aux_inputs(pix["image_grid_thw"]).items()}
    e = jm.get_input_embeddings(jm.params, jnp.asarray(ids),
                                jnp.asarray(pix["pixel_values"]), **aux)
    pos, deltas = jm.prepare_position_ids(ids, pix["image_grid_thw"])
    lm = jm.language_model
    cache = lm.init_cache(1, capacity, jnp.float32)
    logits, cache = jm(jm.params, e, cache, jnp.asarray(pos))
    out = [np.asarray(logits[0, -1])]
    offsets = [int(cache.offset)]
    toks = []
    for _ in range(n_steps - 1):
        tok = int(np.argmax(out[-1]))
        toks.append(tok)
        emb = lm.embed(jm.params["language_model"], jnp.asarray([[tok]]))
        p = jnp.full((3, 1, 1), int(cache.offset) + int(deltas[0, 0]), jnp.int32)
        logits, cache = jm(jm.params, emb, cache, p)
        out.append(np.asarray(logits[0, 0]))
        offsets.append(int(cache.offset))
    return np.stack(out), toks, offsets


def _port_steps(tm, ids, pix, forced, capacity=128):
    aux = tm.vision_aux_inputs(pix["image_grid_thw"])
    e = tm.get_input_embeddings(
        tm.params, torch.from_numpy(ids), torch.from_numpy(pix["pixel_values"]),
        **{k: torch.from_numpy(v) for k, v in aux.items()})
    pos, deltas = tm.prepare_position_ids(ids, pix["image_grid_thw"])
    lm = tm.language_model
    cache = lm.init_cache(1, capacity, torch.float32)
    logits = tm(tm.params, e, cache, torch.from_numpy(pos.astype(np.int64)))
    out = [logits[0, -1].numpy()]
    offsets = [int(cache.offset)]
    for tok in forced:
        emb = lm.embed(tm.params["language_model"], torch.tensor([[tok]]))
        p = torch.full((3, 1, 1), int(cache.offset) + int(deltas[0, 0]))
        logits = tm(tm.params, emb, cache, p)
        out.append(logits[0, 0].numpy())
        offsets.append(int(cache.offset))
    return np.stack(out), offsets


def _bench_rule(ref, got):
    tol = 0.05 * max(1.0, float(np.abs(ref).max()))
    top2 = np.sort(ref, axis=-1)[:, -2:]
    margin_ok = (top2[:, 1] - top2[:, 0]) > 2 * tol
    same = got.argmax(-1) == ref.argmax(-1)
    return float(np.abs(got - ref).max()), tol, margin_ok, same


def test_teacher_forced_prefill_and_decode(models):
    jm, tm, cfg = models
    ids, pix = _inputs(cfg)
    ref, toks, joff = _jax_steps(jm, ids, pix)
    got, toff = _port_steps(tm, ids, pix, toks)
    assert joff == toff == [ids.shape[1] + i for i in range(8)]
    err, tol, margin_ok, same = _bench_rule(ref, got)
    assert err <= tol, (err, tol)
    assert np.all(same[margin_ok])
    # in f32 on one host the two agree far inside the rule
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def _jax_leaf(v):
    """The port's host leaves as the JAX package reads them (bf16 via
    ml_dtypes)."""
    if isinstance(v, torch.Tensor):
        return v.float().numpy().astype(ml_dtypes.bfloat16)
    return v


def test_hf_weight_builder_matches_reference():
    cfg = tiny_qwen2_vl_config()
    ref = jax_hf_weights(cfg, seed=3)
    got = qwen2_vl_hf_weights(cfg, seed=3)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("kind", ["mlx_int4", "dense_f32"])
def test_checkpoint_loads_identically(kind):
    """A random checkpoint through both loaders: the port's params equal the
    JAX package's (for 4-bit: w4grp linears, channel-folded embedding)."""
    cfg = tiny_qwen2_vl_config()
    if kind == "mlx_int4":
        cfg, w = mlx_int4_checkpoint(cfg, seed=2)
    else:
        w = qwen2_vl_hf_weights(cfg, seed=2)

    mp = pytest.MonkeyPatch()
    mp.setenv("MLX_VLM_TPU_FUSED_DECODE", "0")
    try:
        jm = jax_load(dict(cfg), {k: _jax_leaf(v) for k, v in w.items()},
                      jnp.float32)
    finally:
        mp.undo()
    tm = load_model_from_weights(cfg, w, torch.float32, "cpu")
    ref = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jm.params))

    def walk(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
            return
        assert type(a) is type(b), path
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
            return
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f"{path}.{f}"
            else:
                assert x == y, f"{path}.{f}"

    walk(tm.params, ref, "params")


def test_generate_matches_on_tiny_checkpoint(tmp_path):
    """Both packages' load + greedy generate on the same f32 checkpoint."""
    build_tiny_checkpoint(str(tmp_path))
    jm, jp = mlx_vlm_tpu.load(str(tmp_path), dtype=jnp.float32)
    tm, tp = mlx_vlm_tpu_torch.load(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    img = np.random.default_rng(1).integers(0, 256, (56, 56, 3), dtype=np.uint8)
    for text, image in (("What is in this image?", img), ("Describe a cat.", None)):
        n_img = 1 if image is not None else 0
        jprompt = mlx_vlm_tpu.apply_chat_template(jp, jm.config_dict, text,
                                                  num_images=n_img)
        tprompt = mlx_vlm_tpu_torch.apply_chat_template(tp, tm.config_dict,
                                                        text, num_images=n_img)
        jt = [r.token for r in mlx_vlm_tpu.stream_generate(
            jm, jp, jprompt, image=image, max_tokens=8, prefill_step_size=64)]
        tt = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
            tm, tp, tprompt, image=image, max_tokens=8, prefill_step_size=64)]
        assert tt == jt
        out = mlx_vlm_tpu_torch.generate(tm, tp, tprompt, image=image,
                                         max_tokens=8, prefill_step_size=64)
        assert out.generation_tokens == len(tt)
        assert out.finish_reason in ("length", "stop")


def test_generate_matches_on_int4_checkpoint(tmp_path):
    """A random mlx 4-bit checkpoint written to disk: the port's `load_model`
    reads it (numpy safetensors reader) into the same params as the
    in-memory load, and greedy generation over token ids matches the JAX
    package's per-linear w4grp path token for token (float32)."""
    import json

    from safetensors.numpy import save_file

    from mlx_vlm_tpu.generate.dispatch import stream_generate as jax_stream
    from mlx_vlm_tpu_torch.generate.dispatch import stream_generate
    from mlx_vlm_tpu_torch.utils.loader import load_model
    from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

    cfg = _bench_config()
    cfg, w = mlx_int4_checkpoint(cfg, seed=5)
    host = {k: _jax_leaf(v) for k, v in w.items()}
    save_file(host, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    tm = load_model(tmp_path, dtype=torch.float32, device="cpu")
    mem = load_model_from_weights(cfg, w, torch.float32, "cpu")
    q = tm.params["language_model"]["model"]["layers"]["mlp"]["up_proj"]["weight"]
    q_mem = mem.params["language_model"]["model"]["layers"]["mlp"]["up_proj"]["weight"]
    assert torch.equal(q.qp, q_mem.qp) and torch.equal(q.sl, q_mem.sl)
    e, e_mem = (m.params["language_model"]["model"]["embed_tokens"]["weight"]
                for m in (tm, mem))
    assert torch.equal(e.q8, e_mem.q8) and torch.equal(e.scales, e_mem.scales)

    mp = pytest.MonkeyPatch()
    mp.setenv("MLX_VLM_TPU_FUSED_DECODE", "0")
    try:
        jm = jax_load(dict(cfg), dict(host), jnp.float32)
    finally:
        mp.undo()
    tok = ByteTokenizer()
    prompt = [int(t) for t in np.random.default_rng(6).integers(0, 256, 37)]
    jt = [r.token for r in jax_stream(jm, tok, prompt, max_tokens=6,
                                      prefill_step_size=64)]
    tt = [r.token for r in stream_generate(tm, tok, prompt, max_tokens=6,
                                           prefill_step_size=64)]
    assert len(tt) == 6 and tt == jt


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("loader", ["load_model_from_weights", "load_model",
                                    "load"])
def test_loaders_refuse_other_dtypes_on_the_card(loader, dtype):
    """The card's kernels (K1, K4, K5) take bfloat16: a load onto it in
    another dtype is refused at load time, before anything is read, with a
    message that names bfloat16.  CPU loads keep every dtype."""
    import mlx_vlm_tpu_torch.utils.loader as tl

    call = {"load_model_from_weights": lambda: tl.load_model_from_weights(
                tiny_qwen2_vl_config(), {}, dtype, "cuda"),
            "load_model": lambda: tl.load_model("/nonexistent", dtype,
                                                "cuda"),
            "load": lambda: tl.load("/nonexistent", dtype=dtype,
                                    device="cuda")}[loader]
    with pytest.raises(TypeError, match="torch.bfloat16"):
        call()
    cfg, w = mlx_int4_checkpoint(_bench_config(), seed=5)
    tm = tl.load_model_from_weights(cfg, w, dtype, "cpu")
    emb = tm.params["language_model"]["model"]["embed_tokens"]["weight"]
    assert emb.scales.dtype == dtype


def test_block_size_sizes_the_cache_as_the_reference(models, monkeypatch):
    """generate_step takes block_size and sizes the cache by the
    reference's rule, round_up(S + max_tokens + max(1, min(block_size,
    max_tokens)) + 1, 256): at S = 7900 and max_tokens = 20 both packages
    make an 8192-slot cache (the flash prefill's size)."""
    import importlib

    # `generate` is also each package's function, so import by module name
    jar = importlib.import_module("mlx_vlm_tpu.generate.ar")
    tar = importlib.import_module("mlx_vlm_tpu_torch.generate.ar")
    jm, tm, cfg = models
    made = {}

    class Made(Exception):
        pass

    def spy(name):
        def make_cache(model, batch_size, capacity, *args, **kwargs):
            made[name] = capacity
            raise Made
        return make_cache

    monkeypatch.setattr(jar, "make_cache", spy("jax"))
    monkeypatch.setattr(tar, "make_cache", spy("port"))
    D = cfg["hidden_size"]
    for kw in ({}, {"block_size": 32}):
        made.clear()
        with pytest.raises(Made):
            next(jar.generate_step(jnp.zeros((1, 7900, D), jnp.float32), jm,
                                   max_tokens=20, **kw))
        with pytest.raises(Made):
            next(tar.generate_step(torch.zeros((1, 7900, D)), tm,
                                   max_tokens=20, **kw))
        assert made == {"jax": 8192, "port": 8192}
    with pytest.raises(Made):
        next(tar.generate_step(torch.zeros((1, 7900, D)), tm, max_tokens=20,
                               block_size=8))
    assert made["port"] == 7936  # 7900 + 20 + 8 + 1 rounds up to 7936


def test_block_size_is_accepted_and_keeps_the_tokens(models):
    """block_size=8 through stream_generate and generate gives the default's
    tokens: the block size changes how many steps a host fetch takes, not
    the steps."""
    from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

    _, tm, _ = models
    tok = ByteTokenizer()
    prompt = [int(t) for t in np.random.default_rng(8).integers(0, 256, 21)]
    runs = [[r.token for r in mlx_vlm_tpu_torch.stream_generate(
        tm, tok, prompt, max_tokens=6, prefill_step_size=64, **kw)]
        for kw in ({}, {"block_size": 8})]
    assert len(runs[0]) == 6 and runs[1] == runs[0]
    out = mlx_vlm_tpu_torch.generate(tm, tok, prompt, max_tokens=6,
                                     prefill_step_size=64, block_size=8)
    assert out.generation_tokens == 6 and out.token == runs[0][-1]
