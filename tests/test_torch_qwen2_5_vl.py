"""Port parity: the Qwen2.5-VL family (models/qwen2_5_vl) against the JAX
package, both in float32 on the CPU on the same parameters (carried by
`params_from_jax`), at a tiny size (hidden 64, 2 decoder layers, a
3-block windowed vision tower):

- host layouts exactly: `window_partition_aux` (patch permutation,
  `seg_full`, `seg_win`, `reverse_index`, rotary freqs) over grids that do
  and do not fill their windows, several images and frames;
  `prepare_position_ids`; the config's flat / nested merge; `sanitize`;
  the HF weight builder; the processors' tensors;
- the vision tower (window and full blocks) within 1e-4 of the JAX
  package's, the merged embeddings too;
- teacher-forced logits by bench.py's rule (and within 1e-3), greedy
  `generate` tokens equal for a text and an image prompt on a checkpoint
  on disk, `batch_generate` and the server answering as the JAX
  package's;
- the loader: a 4-bit checkpoint loads as w4grp with the fused route on
  (the reference's default for a language model with the fused step),
  and the JAX package's int4 tree (its fused pack) carries over.
"""

import json
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu.models.qwen2_5_vl import ModelConfig as JaxConfig
from mlx_vlm_tpu.models.qwen2_5_vl.qwen2_5_vl import Model as JaxModel
from mlx_vlm_tpu.models.qwen2_5_vl.vision import \
    window_partition_aux as jax_window_aux
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import build_tiny_checkpoint
from mlx_vlm_tpu.utils.testing import qwen2_5_vl_hf_weights as jax_hf_weights
from mlx_vlm_tpu.utils.testing import \
    tiny_qwen2_5_vl_config as jax_tiny_config
from mlx_vlm_tpu_torch.core.quant import (ChannelQuantizedTensor,
                                          Int4GroupedTensor)
from mlx_vlm_tpu_torch.models.qwen2_5_vl import Model, ModelConfig
from mlx_vlm_tpu_torch.models.qwen2_5_vl.vision import window_partition_aux
from mlx_vlm_tpu_torch.utils.loader import (load_model_from_weights,
                                            params_from_jax)
from mlx_vlm_tpu_torch.utils.testing import (mlx_int4_checkpoint,
                                             qwen2_5_vl_7b_config,
                                             qwen2_5_vl_hf_weights,
                                             tiny_qwen2_5_vl_config)

torch.set_num_threads(2)

GRIDS = ([[1, 8, 12]], [[1, 10, 6]], [[1, 4, 4], [2, 6, 10]], [[1, 14, 18]])


def bench_rule(ref, got):
    """bench.py's rule: (max error, tolerance, margin rows, argmax equal)."""
    tol = 0.05 * max(1.0, float(np.abs(ref).max()))
    top2 = np.sort(ref, axis=-1)[:, -2:]
    margin_ok = (top2[:, 1] - top2[:, 0]) > 2 * tol
    same = got.argmax(-1) == ref.argmax(-1)
    return float(np.abs(got - ref).max()), tol, margin_ok, same


def jax_leaf(v):
    """A port host leaf as the JAX package reads it (bf16 via ml_dtypes)."""
    if isinstance(v, torch.Tensor):
        return v.float().numpy().astype(ml_dtypes.bfloat16)
    return v


def port_of(jm, cls_model, cls_config, cfg):
    """The port's model on the JAX model's parameters."""
    tm = cls_model(cls_config.from_dict(cfg))
    tm.params = params_from_jax(tm, jax.tree_util.tree_map(np.asarray,
                                                           jm.params))
    tm.config_dict = cfg
    tm.device = torch.device("cpu")
    return tm


def tree_equal(a, b, path="params", values_only=False):
    """Two port parameter trees hold the same leaves, byte for byte; with
    `values_only`, the same values (a fused pack keeps the q/k/v biases in
    f32 and its own out_dtype)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            tree_equal(a[k], b[k], f"{path}.{k}", values_only)
        return
    assert type(a) is type(b), path
    if isinstance(a, torch.Tensor):
        if values_only:
            a, b = a.double(), b.double()
        assert a.dtype == b.dtype and torch.equal(a, b), path
        return
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f"{path}.{f}"
        elif not (values_only and f == "out_dtype"):
            assert x == y, f"{path}.{f}"


def image_inputs(model, grid, seed=0):
    """Random patch rows for `grid` [[t, h, w], ...] at the model's patch
    size, and a prompt holding its merged tokens between text tokens."""
    vc = model.config.vision_config
    grid = np.asarray(grid)
    n = int(np.prod(grid, axis=1).sum())
    dim = 3 * vc.temporal_patch_size * vc.patch_size**2
    pix = (np.random.default_rng(seed).standard_normal((n, dim)) * 0.5
           ).astype(np.float32)
    it = model.config.image_token_id
    ids = np.array([[5, 6, 7] + [it] * (n // vc.spatial_merge_size**2)
                    + [8, 9, 10, 11]], np.int64)
    return ids, pix, grid


def teacher_forced(jm, tm, ids, pix, grid, n_steps=6, capacity=128):
    """(JAX logits [n, V], port logits [n, V]): the prompt, then n - 1
    decode steps fed the JAX package's greedy tokens."""
    jaux = {k: jnp.asarray(v) for k, v in jm.vision_aux_inputs(grid).items()}
    taux = {k: torch.from_numpy(np.asarray(v))
            for k, v in tm.vision_aux_inputs(grid).items()}
    je = jm.get_input_embeddings(jm.params, jnp.asarray(ids),
                                 jnp.asarray(pix), **jaux)
    te = tm.get_input_embeddings(tm.params, torch.from_numpy(ids),
                                 torch.from_numpy(pix), **taux)
    pos, deltas = jm.prepare_position_ids(ids, grid)
    tpos, tdeltas = tm.prepare_position_ids(ids, grid)
    assert np.array_equal(pos, tpos) and np.array_equal(deltas, tdeltas)
    jc = jm.language_model.init_cache(1, capacity, jnp.float32)
    tc = tm.language_model.init_cache(1, capacity, torch.float32)
    jl, jc = jm(jm.params, je, jc, jnp.asarray(pos))
    tl = tm(tm.params, te, tc, torch.from_numpy(pos.astype(np.int64)))
    ref, got = [np.asarray(jl[0, -1])], [tl[0, -1].numpy()]
    for _ in range(n_steps - 1):
        tok = int(np.argmax(ref[-1]))
        p = int(deltas[0, 0]) + int(jc.offset)
        jl, jc = jm(jm.params, jm.language_model.embed(
            jm.params["language_model"], jnp.asarray([[tok]])), jc,
            jnp.full((3, 1, 1), p, jnp.int32))
        tl = tm(tm.params, tm.language_model.embed(
            tm.params["language_model"], torch.tensor([[tok]])), tc,
            torch.full((3, 1, 1), p))
        ref.append(np.asarray(jl[0, 0]))
        got.append(tl[0, 0].numpy())
    assert int(jc.offset) == int(tc.offset) == ids.shape[1] + n_steps - 1
    return np.stack(ref), np.stack(got)


def write_checkpoint(directory, family_config, weights_fn, seed=11):
    """A checkpoint on disk: build_tiny_checkpoint's trained tokenizer with
    `family_config(vocab, token ids)`'s config and `weights_fn(cfg)`'s
    weights.  Returns the config."""
    from safetensors.numpy import save_file

    base = build_tiny_checkpoint(str(directory), seed=seed)
    cfg = family_config(base)
    save_file({k: jax_leaf(v) for k, v in weights_fn(cfg).items()},
              str(directory / "model.safetensors"))
    (directory / "config.json").write_text(json.dumps(cfg))
    return cfg


def _tiny_on_disk(base):
    return tiny_qwen2_5_vl_config(
        vocab_size=base["vocab_size"], image_token_id=base["image_token_id"],
        video_token_id=base["video_token_id"],
        vision_start_token_id=base["vision_start_token_id"],
        eos_token_id=base["eos_token_id"])


@pytest.fixture(scope="module")
def models():
    cfg = tiny_qwen2_5_vl_config()
    jm = jax_load(dict(cfg), jax_hf_weights(cfg, seed=2), jnp.float32)
    return jm, port_of(jm, Model, ModelConfig, cfg), cfg


@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    """(JAX (model, processor), port (model, processor)) of one tiny
    checkpoint on disk with a trained tokenizer."""
    d = tmp_path_factory.mktemp("tiny_qwen2_5_vl")
    write_checkpoint(d, _tiny_on_disk,
                     lambda c: qwen2_5_vl_hf_weights(c, seed=11, scale=0.5))
    return (mlx_vlm_tpu.load(str(d), dtype=jnp.float32),
            mlx_vlm_tpu_torch.load(str(d), dtype=torch.float32,
                                   device="cpu"))


# ------------------------------------------------------------ host layouts


@pytest.mark.parametrize("grid", GRIDS)
def test_window_partition_aux_equals_reference(grid):
    cfg = ModelConfig.from_dict(tiny_qwen2_5_vl_config()).vision_config
    jcfg = JaxConfig.from_dict(jax_tiny_config()).vision_config
    got = window_partition_aux(np.asarray(grid), cfg)
    ref = jax_window_aux(np.asarray(grid), jcfg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k],
                                                               ref[k]), k
    # a permutation and its inverse
    n = len(got["window_index"])
    assert np.array_equal(got["window_index"][got["reverse_index"]],
                          np.arange(n))


def test_config_merges_flat_and_nested_text_params():
    flat = qwen2_5_vl_7b_config()
    nested = dict(flat, text_config={"hidden_size": 3584,
                                     "num_hidden_layers": 3,
                                     "rope_scaling": None})
    for d in (flat, nested):
        got = ModelConfig.from_dict(json.loads(json.dumps(d)))
        ref = JaxConfig.from_dict(json.loads(json.dumps(d)))
        assert got.text_config.__dict__ == ref.text_config.__dict__
        assert got.vision_config.__dict__ == ref.vision_config.__dict__
    assert ModelConfig.from_dict(nested).text_config.num_hidden_layers == 3


def test_hf_weight_builder_matches_reference():
    cfg = tiny_qwen2_5_vl_config()
    assert cfg == jax_tiny_config()
    ref = jax_hf_weights(cfg, seed=3)
    got = qwen2_5_vl_hf_weights(cfg, seed=3)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k])


def test_sanitize_equals_reference():
    w = qwen2_5_vl_hf_weights(tiny_qwen2_5_vl_config(), seed=1)
    w["visual.rotary_pos_emb.position_ids"] = np.arange(4)
    got, ref = Model.sanitize(dict(w)), JaxModel.sanitize(dict(w))
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and np.array_equal(got[k], ref[k])
    assert got["vision_tower.patch_embed.proj.weight"].ndim == 2


def test_prepare_position_ids_equal(models):
    jm, tm, _ = models
    for grid in GRIDS:
        ids, _, grid = image_inputs(tm, grid)
        for g in (grid, None):
            got = tm.prepare_position_ids(ids, g)
            ref = jm.prepare_position_ids(ids, g)
            assert all(np.array_equal(a, b) for a, b in zip(got, ref))


# ------------------------------------------------------------ float paths


@pytest.mark.parametrize("grid", GRIDS[:3])
def test_vision_tower_and_embeddings(models, grid):
    jm, tm, _ = models
    ids, pix, grid = image_inputs(tm, grid)
    jaux = {k: jnp.asarray(v) for k, v in jm.vision_aux_inputs(grid).items()}
    taux = {k: torch.from_numpy(v)
            for k, v in tm.vision_aux_inputs(grid).items()}
    ref = np.asarray(jm.get_input_embeddings(
        jm.params, jnp.asarray(ids), jnp.asarray(pix), **jaux))
    got = tm.get_input_embeddings(tm.params, torch.from_numpy(ids),
                                  torch.from_numpy(pix), **taux).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    feats = tm.vision_tower(tm.params["vision_tower"], torch.from_numpy(pix),
                            *(taux[k] for k in (
                                "rotary_freqs", "seg_full", "seg_win",
                                "patch_perm", "reverse_index")))
    jfeats = jm.vision_tower(jm.params["vision_tower"], jnp.asarray(pix),
                             *(jaux[k] for k in (
                                 "rotary_freqs", "seg_full", "seg_win",
                                 "patch_perm", "reverse_index")))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-4,
                               rtol=1e-4)
    assert not hasattr(tm, "vision_features")  # as the reference


def test_teacher_forced_logits(models):
    jm, tm, _ = models
    ids, pix, grid = image_inputs(tm, GRIDS[0])
    ref, got = teacher_forced(jm, tm, ids, pix, grid)
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_generate_matches_on_checkpoint(on_disk):
    """Both packages' load + greedy generate on the same checkpoint, a text
    and an image prompt; the processors give the same tensors."""
    (jm, jp), (tm, tp) = on_disk
    img = np.random.default_rng(1).integers(0, 256, (84, 112, 3),
                                            dtype=np.uint8)
    for text, image in (("Describe a cat.", None),
                        ("What is in this image?", img)):
        n_img = int(image is not None)
        jprompt = mlx_vlm_tpu.apply_chat_template(jp, jm.config_dict, text,
                                                  num_images=n_img)
        tprompt = mlx_vlm_tpu_torch.apply_chat_template(
            tp, tm.config_dict, text, num_images=n_img)
        assert jprompt == tprompt
        if image is not None:
            from mlx_vlm_tpu.utils.processing import prepare_inputs as jprep

            from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

            ref = jprep(jp, jprompt, images=image)
            got = prepare_inputs(tp, tprompt, images=image)
            assert sorted(got) == sorted(ref)
            for k in ref:
                assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k]))
        jt = [r.token for r in mlx_vlm_tpu.stream_generate(
            jm, jp, jprompt, image=image, max_tokens=8, prefill_step_size=64)]
        tt = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
            tm, tp, tprompt, image=image, max_tokens=8, prefill_step_size=64)]
        assert tt == jt and len(tt) == 8
        out = mlx_vlm_tpu_torch.generate(tm, tp, tprompt, image=image,
                                         max_tokens=8, prefill_step_size=64)
        assert out.generation_tokens == 8


def test_batch_generate_matches_jax(on_disk):
    from mlx_vlm_tpu.generate.batch import batch_generate as jbatch

    from mlx_vlm_tpu_torch.generate.batch import batch_generate

    (jm, jp), (tm, tp) = on_disk
    img = np.random.default_rng(2).integers(0, 256, (56, 84, 3),
                                            dtype=np.uint8)
    texts = ["Describe a cat.", "What is in this image?", "Hello there."]
    prompts = [mlx_vlm_tpu_torch.apply_chat_template(
        tp, tm.config_dict, t, num_images=int(i == 1))
        for i, t in enumerate(texts)]
    images = [None, img, None]
    ref = jbatch(jm, jp, prompts, images=images, max_tokens=6, num_slots=4,
                 capacity=256)
    got = batch_generate(tm, tp, prompts, images=images, max_tokens=6,
                         num_slots=4, capacity=256)
    assert got.texts == ref.texts


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def serve_chats(models_procs, bodies, name):
    """Each (package, model, processor)'s server answers `bodies` in turn:
    {package: [response json, ...]}."""
    from mlx_vlm_tpu.server.app import create_server as jax_create

    from mlx_vlm_tpu_torch.server.app import create_server

    out = {}
    for pkg, model, proc in models_procs:
        make = jax_create if pkg == "jax" else create_server
        port = _free_port()
        httpd = make(model, proc, model_name=name, host="127.0.0.1",
                     port=port, num_slots=2, capacity=256, block_size=2,
                     token_queue_timeout=120.0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            out[pkg] = []
            for body in bodies:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/chat/completions",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    out[pkg].append(json.loads(r.read()))
        finally:
            httpd.shutdown()
            httpd.state.generator.shutdown()
    return out


def png_data_uri(size=(56, 84), seed=0):
    import base64
    import io

    from PIL import Image

    img = Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (*size, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def test_server_answers_as_jax(on_disk):
    (jm, jp), (tm, tp) = on_disk
    bodies = [
        {"messages": [{"role": "user", "content": "Describe a cat."}],
         "max_tokens": 6},
        {"messages": [{"role": "user", "content": [
            {"type": "text", "text": "What is in this image?"},
            {"type": "image_url", "image_url": {"url": png_data_uri()}}]}],
         "max_tokens": 6},
    ]
    out = serve_chats([("jax", jm, jp), ("port", tm, tp)], bodies,
                      "tiny-qwen2.5-vl")
    for ref, got in zip(out["jax"], out["port"]):
        assert (got["choices"][0]["message"]["content"]
                == ref["choices"][0]["message"]["content"])
        assert got["usage"] == ref["usage"]


# ------------------------------------------------------------ the loader


def test_int4_checkpoint_loads_w4grp_on_the_fused_route():
    """A 4-bit checkpoint: w4grp linears and the fused route on in the
    port, as the JAX package's default (which builds its pack); the JAX
    tree, pack included, carries over to the port's own load."""
    cfg = tiny_qwen2_5_vl_config(hidden_size=128, intermediate_size=256,
                                 rope_scaling={"type": "mrope",
                                               "mrope_section": [4, 6, 6]})
    cfg, w = mlx_int4_checkpoint(cfg, seed=4)
    tm = load_model_from_weights(cfg, w, torch.bfloat16, "cpu")
    lp = tm.params["language_model"]
    assert isinstance(lp["model"]["layers"]["mlp"]["up_proj"]["weight"],
                      Int4GroupedTensor)
    assert isinstance(lp["model"]["embed_tokens"]["weight"],
                      ChannelQuantizedTensor)
    assert tm.language_model.fused_decode
    jm = jax_load(dict(cfg), {k: jax_leaf(v) for k, v in w.items()},
                  jnp.bfloat16)
    assert "fused_decode" in jm.params["language_model"]
    ref = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    layers = "layers"
    tree_equal(tm.params["language_model"]["model"].pop(layers),
               ref["language_model"]["model"].pop(layers), values_only=True)
    tree_equal(tm.params, ref)
