"""Port parity: the classic decoders on models/classic_base.py (gpt2,
gpt_neox, gpt_bigcode, phi, phixtral, qwen, stablelm, starcoder2,
nemotron) against the JAX package, in float32 on the CPU on
numpy-seeded weights in each family's HF layout (`tiny_classic_config`:
hidden 64, 2 layers, 4 heads of 16, vocab 128).

- each published config parsed as the JAX package parses it (phi-2's
  too), the loader's dispatch, and `sanitize` key for key on the HF
  layout;
- logits without a cache, then teacher-forced through the cache (an
  8-token prefill and 3 decode steps), within 1e-4; the parameters carry
  over from the JAX package's load;
- fault 2 (ROADMAP Queue 3): a 4-bit mlx checkpoint of each family (every
  linear, the embedding tables and the head quantized, group 32) loads
  exact in the port, whose logits equal (within 1e-5) those of the same
  model with every weight dequantized to a dense f32 tensor; the JAX
  package's load of it fails or gives other logits;
- a checkpoint directory through `load` and greedy `stream_generate`
  (its first token the argmax of the prompt's uncached logits).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlx_vlm_tpu_torch
from mlx_vlm_tpu.utils.loader import get_model_and_args as jax_model_and_args
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu_torch.core.layers import dense_weight
from mlx_vlm_tpu_torch.core.quant import QuantizedTensor
from mlx_vlm_tpu_torch.utils.loader import (get_model_and_args,
                                            load_model_from_weights,
                                            params_from_jax)
from mlx_vlm_tpu_torch.utils.testing import (CLASSIC_TYPES,
                                             classic_hf_weights,
                                             mlx_quantized_checkpoint,
                                             phi_2_config,
                                             tiny_classic_config)
from test_torch_qwen2_5_vl import jax_leaf, tree_equal

torch.set_num_threads(2)

IDS = (np.arange(8, dtype=np.int64) * 7 % 120)[None]


def _pos(S, start=0):
    return np.broadcast_to(np.arange(start, start + S, dtype=np.int32),
                           (3, 1, S)).copy()


@pytest.fixture(scope="module", params=CLASSIC_TYPES)
def pair(request):
    cfg = tiny_classic_config(request.param)
    w = classic_hf_weights(cfg, seed=3)
    return (jax_load(dict(cfg), dict(w), jnp.float32),
            load_model_from_weights(cfg, dict(w), torch.float32, "cpu"), cfg)


@pytest.mark.parametrize("kind", CLASSIC_TYPES + ("phi-2",))
def test_config_and_sanitize_equal_reference(kind):
    cfg = phi_2_config() if kind == "phi-2" else tiny_classic_config(kind)
    arch, as_type = get_model_and_args(cfg)
    jarch, jtype = jax_model_and_args(cfg)
    assert as_type == jtype == cfg["model_type"]
    got = arch.ModelConfig.from_dict(json.loads(json.dumps(cfg)))
    ref = jarch.ModelConfig.from_dict(json.loads(json.dumps(cfg)))
    assert got.__dict__ == ref.__dict__
    if kind == "phi-2":
        assert (got.hidden_size, got.num_hidden_layers, got.head_dim,
                int(got.head_dim * got.rope_pct), got.intermediate_size,
                got.vocab_size) == (2560, 32, 80, 32, 10240, 51200)
        return
    w = classic_hf_weights(cfg, seed=4)
    a = arch.Model(got).sanitize(dict(w))
    b = jarch.Model(ref).sanitize(dict(w))
    assert list(a) == list(b)
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in b)


def test_logits_without_and_with_cache(pair):
    jm, tm, _ = pair
    S = IDS.shape[1]
    je = jm.get_input_embeddings(jm.params, jnp.asarray(IDS))
    te = tm.get_input_embeddings(tm.params, torch.from_numpy(IDS))
    ref = np.asarray(jm(jm.params, je, None, jnp.asarray(_pos(S)))[0])
    got = tm(tm.params, te, None, torch.from_numpy(_pos(S))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    jc = jm.language_model.init_cache(1, 16, jnp.float32)
    tc = tm.language_model.init_cache(1, 16, torch.float32)
    jl, jc = jm(jm.params, je, jc, jnp.asarray(_pos(S)))
    tl = tm(tm.params, te, tc, torch.from_numpy(_pos(S)))
    refs, gots = [np.asarray(jl)[0, -1]], [tl[0, -1].numpy()]
    for t in range(3):
        tok = np.array([[int(np.argmax(refs[-1]))]])
        jl, jc = jm(jm.params, jm.get_input_embeddings(
            jm.params, jnp.asarray(tok)), jc, jnp.asarray(_pos(1, S + t)))
        tl = tm(tm.params, tm.get_input_embeddings(
            tm.params, torch.from_numpy(tok)), tc,
            torch.from_numpy(_pos(1, S + t)))
        refs.append(np.asarray(jl)[0, 0])
        gots.append(tl[0, 0].numpy())
    assert int(tc.offset) == int(jc.offset) == S + 3
    np.testing.assert_allclose(np.stack(gots), np.stack(refs), rtol=1e-4,
                               atol=1e-4)
    import jax

    tree_equal(tm.params, params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))


def _dense(tree):
    """The tree with every quantized weight dequantized to dense f32."""
    if isinstance(tree, dict):
        return {k: _dense(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return dense_weight(tree).float()
    return tree


@pytest.mark.parametrize("kind", CLASSIC_TYPES)
def test_quantized_tables_fault(monkeypatch, kind):
    monkeypatch.setenv("MLX_VLM_TPU_RUNTIME_QUANT", "exact")
    cfg, w = mlx_quantized_checkpoint(tiny_classic_config(kind),
                                      group_size=32, seed=7)
    tm = load_model_from_weights(cfg, dict(w), torch.float32, "cpu")
    lp = tm.params["language_model"]
    assert isinstance(lp["model"]["wte"]["weight"], QuantizedTensor)
    S = IDS.shape[1]
    e = tm.get_input_embeddings(tm.params, torch.from_numpy(IDS))
    got = tm(tm.params, e, None, torch.from_numpy(_pos(S))).numpy()
    dense = {"language_model": _dense(lp)}
    want = tm(dense, tm.get_input_embeddings(dense, torch.from_numpy(IDS)),
              None, torch.from_numpy(_pos(S))).numpy()
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    try:
        jm = jax_load(cfg, {k: jax_leaf(v) for k, v in w.items()},
                      jnp.float32)
        je = jm.get_input_embeddings(jm.params, jnp.asarray(IDS))
        ref = np.asarray(jm(jm.params, je, None, jnp.asarray(_pos(S)))[0])
    except Exception:  # noqa: BLE001 — the reference fails on the layout
        return
    assert ref.shape != got.shape or not np.allclose(ref, got, atol=1e-3)


@pytest.fixture(scope="module")
def hf_tokenizer():
    """A byte-level BPE of 300 ids trained in memory, with ChatML's
    markers as special tokens (transformers' PreTrainedTokenizerFast)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(["Describe a cat.", "def fibonacci(n):"] * 8,
                            trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<|endoftext|>", "<|im_start|>",
                                        "<|im_end|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return PreTrainedTokenizerFast(tokenizer_object=tok,
                                   eos_token="<|im_end|>",
                                   pad_token="<|endoftext|>")


@pytest.mark.parametrize("kind", CLASSIC_TYPES)
def test_load_and_stream_generate(kind, tmp_path, hf_tokenizer):
    """A checkpoint directory (safetensors, config.json, a tokenizer)
    through `load` and greedy `stream_generate`: its first token is the
    argmax of the prompt's uncached logits."""
    from mlx_vlm_tpu_torch.utils.loader import write_safetensors

    cfg = tiny_classic_config(kind, eos_token_id=2)
    for k in ("vocab_size", "num_vocab"):
        if k in cfg:
            cfg[k] = 320
    write_safetensors(tmp_path / "model.safetensors",
                      classic_hf_weights(cfg, seed=5, scale=0.3))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    hf_tokenizer.save_pretrained(str(tmp_path))
    tm, proc = mlx_vlm_tpu_torch.load(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    prompt = mlx_vlm_tpu_torch.apply_chat_template(proc, tm.config_dict,
                                                   "Describe a cat.")
    toks = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
        tm, proc, prompt, max_tokens=4, prefill_step_size=64)]
    assert 1 <= len(toks) <= 4
    ids = np.asarray(hf_tokenizer(prompt)["input_ids"], np.int64)[None]
    S = ids.shape[1]
    e = tm.get_input_embeddings(tm.params, torch.from_numpy(ids))
    first = tm(tm.params, e, None, torch.from_numpy(_pos(S)))[0, -1]
    assert toks[0] == int(first.argmax())


def test_new_packages_import_no_jax():
    """gpt_oss, the classic families, trainer/lora.py and core/stopping.py
    import neither JAX nor the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    mods = ["gpt_oss", "classic_base", *CLASSIC_TYPES]
    code = ("import sys\n"
            + "".join(f"import mlx_vlm_tpu_torch.models.{m}\n" for m in mods)
            + "import mlx_vlm_tpu_torch.trainer.lora\n"
            "import mlx_vlm_tpu_torch.core.stopping\n"
            "bad = [m for m in ('jax', 'mlx_vlm_tpu') if m in sys.modules]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(repo),
                         env={**os.environ, "PYTHONPATH": str(repo)},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
