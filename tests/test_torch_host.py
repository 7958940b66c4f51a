"""Port parity: host code (processing, templates, M-RoPE ids, loading).

Host code and integer layouts must equal the JAX package's exactly."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu import prompt_utils as jpu
from mlx_vlm_tpu.models.qwen2_vl.language import mrope_position_ids as jax_mrope
from mlx_vlm_tpu.utils import processing as jproc
from mlx_vlm_tpu.utils.testing import build_tiny_checkpoint
from mlx_vlm_tpu_torch import prompt_utils as tpu
from mlx_vlm_tpu_torch.models.qwen2_vl.language import mrope_position_ids
from mlx_vlm_tpu_torch.utils import processing as tproc
from mlx_vlm_tpu_torch.utils.loader import read_safetensors
from mlx_vlm_tpu_torch.utils.testing import QWEN2_VL_SPECIAL_TOKENS, ByteTokenizer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_qwen2_vl")
    build_tiny_checkpoint(str(d))
    return d


@pytest.mark.parametrize("hw", [(56, 84), (224, 224), (37, 1000), (3000, 20),
                                (448, 448), (30, 30)])
def test_smart_resize_equal(hw):
    assert tproc.smart_resize(*hw) == jproc.smart_resize(*hw)


@pytest.mark.parametrize("hw", [(56, 84), (61, 97)])
def test_image_processor_equal(hw):
    """(56, 84) already meets the resize rule: the port skips PIL there,
    and the pixels still equal the reference's PIL round trip."""
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = jproc.Qwen2VLImageProcessor()(img)
    got = tproc.Qwen2VLImageProcessor()(img)
    assert np.array_equal(got["image_grid_thw"], ref["image_grid_thw"])
    assert got["pixel_values"].dtype == ref["pixel_values"].dtype
    assert np.array_equal(got["pixel_values"], ref["pixel_values"])
    same = tproc.smart_resize(*hw) == hw
    assert same == (hw == (56, 84))


def test_load_image_array_passthrough():
    img = np.zeros((28, 28, 3), np.uint8)
    assert tproc.load_image(img) is img
    with pytest.raises(ValueError):
        tproc.load_image(np.zeros((28, 28), np.uint8))


def test_prepare_inputs_equal_on_tiny_checkpoint(tiny_dir):
    jm, jp = mlx_vlm_tpu.load(str(tiny_dir))
    tm, tp = mlx_vlm_tpu_torch.load(str(tiny_dir), dtype=torch.float32,
                                      device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (84, 56, 3), dtype=np.uint8)
    for text, n_img in (("What is in this image?", 1), ("Describe", 2),
                        ("A cat sat on a mat.", 0)):
        jprompt = mlx_vlm_tpu.apply_chat_template(jp, jm.config_dict, text,
                                                  num_images=n_img)
        tprompt = mlx_vlm_tpu_torch.apply_chat_template(
            tp, tm.config_dict, text, num_images=n_img)
        assert tprompt == jprompt
        images = [img] * n_img if n_img else None
        ref = jproc.prepare_inputs(jp, jprompt, images=images)
        got = tproc.prepare_inputs(tp, tprompt, images=images)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("with_mask", [False, True])
def test_mrope_position_ids_equal(with_mask):
    img, vid = 7, 8
    ids = np.array([
        [1, 2, img, img, img, img, 3, img, img, img, img, img, img, 4, 5],
        [0, 0, 9, 9, img, img, img, img, img, img, img, img, 6, 6, 6],
    ])
    grid = np.array([[1, 4, 4], [1, 4, 6], [1, 4, 8]])
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    kw = dict(merge=2, image_token_id=img, video_token_id=vid)
    am = mask if with_mask else None
    ref = jax_mrope(ids, grid, None, am, **kw)
    got = mrope_position_ids(ids, grid, None, am, **kw)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    # text only, left-padded
    ref = jax_mrope(ids, None, None, mask, **kw)
    got = mrope_position_ids(ids, None, None, mask, **kw)
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)


@pytest.mark.parametrize("model_type,prompt", [
    ("qwen2_vl", "Describe."),
    ("qwen2_vl", [{"role": "system", "content": "Be brief."},
                  {"role": "user", "content": "What is this?"}]),
    ("paligemma", "caption en"),
    ("unknown_family", "hi"),
])
def test_chat_template_copy_equal(model_type, prompt):
    tok = ByteTokenizer()
    cfg = {"model_type": model_type}
    for n in (0, 1, 2):
        if model_type == "paligemma" and n > 1:
            continue
        assert tpu.apply_chat_template(tok, cfg, prompt, num_images=n) == \
            jpu.apply_chat_template(tok, cfg, prompt, num_images=n)


def test_byte_tokenizer_round_trip():
    tok = ByteTokenizer()
    text = "<|im_start|>user\nhé <|image_pad|><|image_pad|>!<|im_end|>"
    ids = tok.encode(text)
    assert ids[0] == QWEN2_VL_SPECIAL_TOKENS["<|im_start|>"]
    assert ids.count(151655) == 2
    assert tok.decode(ids) == text
    assert tok.decode(ids, skip_special_tokens=True) == "user\nhé !"
    enc = tok(["ab", "abcd"], return_tensors="np", padding=True,
              padding_side="left")
    assert enc["input_ids"].tolist() == [[151643, 151643, 97, 98],
                                         [97, 98, 99, 100]]
    assert enc["attention_mask"].tolist() == [[0, 0, 1, 1], [1, 1, 1, 1]]
    assert tok.convert_ids_to_tokens(32) == "Ġ"
    assert tok.convert_ids_to_tokens([151645, 97]) == ["<|im_end|>", "a"]
    assert tok.eos_token_id in tok.all_special_ids


def test_read_safetensors_matches_library(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.f32": torch.randn((3, 4), generator=g),
        "b.bf16": torch.randn((5, 2), generator=g).to(torch.bfloat16),
        "c.f16": torch.randn((7,), generator=g).half(),
        "d.u8": torch.randint(0, 255, (4, 4), generator=g, dtype=torch.uint8),
        "e.i64": torch.arange(6).reshape(2, 3),
    }
    path = tmp_path / "x.safetensors"
    save_file(tensors, str(path))
    got = read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        g_ = got[k]
        if t.dtype == torch.bfloat16:
            assert isinstance(g_, torch.Tensor) and g_.dtype == torch.bfloat16
            assert torch.equal(g_, t)
        else:
            assert np.array_equal(g_, t.numpy()) and g_.dtype == t.numpy().dtype


def test_import_pulls_in_no_jax_or_optional_packages():
    code = (
        "import sys, mlx_vlm_tpu_torch, mlx_vlm_tpu_torch.utils.testing, "
        "mlx_vlm_tpu_torch.ops.int4_matvec, mlx_vlm_tpu_torch.ops.flash_attention\n"
        "bad = [m for m in ('jax', 'mlx_vlm_tpu', 'transformers', 'tokenizers', "
        "'safetensors', 'PIL', 'triton', 'ml_dtypes', 'cv2') "
        "if m in sys.modules]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("arg", ["kv_bits", "draft_model", "audio",
                                 "video"])
def test_unported_arguments_raise(arg):
    """Arguments the port cannot take raise before any work.  `kv_bits` is
    ported; a bit width no cache takes (6) raises the reference's
    ValueError before any work.  `draft_model` is ported; a drafter of
    another vocabulary raises ValueError before any work.  `video` is
    ported for the Qwen-VL line; a model whose config has no video token
    (LLaVA's, a text-only llama's) raises NotImplementedError before any
    work."""
    import types

    from mlx_vlm_tpu_torch.generate.dispatch import stream_generate

    model, value, exc = None, 1, NotImplementedError
    if arg == "video":
        model = types.SimpleNamespace(
            config=types.SimpleNamespace(model_type="llava",
                                         image_token_index=32000),
            config_dict={"model_type": "llava"})
    elif arg == "kv_bits":
        value, exc = 6, ValueError
    elif arg == "draft_model":
        model = types.SimpleNamespace(config_dict={"vocab_size": 256})
        value = types.SimpleNamespace(config_dict={"vocab_size": 300})
        exc = ValueError
    with pytest.raises(exc):
        next(stream_generate(model, None, "hi", **{arg: value}))
