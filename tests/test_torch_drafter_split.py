"""Port parity: the drafter split tool (speculative/split.py) against the
JAX package's on the same source checkpoints (tests/test_drafter_split.py's
MTP tensors and decoys, written with `safetensors`): the rules and their
renames exactly; each family's output directory exactly (config.json's
text, every tensor's name, dtype, shape and bytes, the copied tokenizer
files), from a single file and from an index of shards, BF16 included;
`verify_split`'s report and its refusal of a corrupted file; the command
line (`python -m mlx_vlm_tpu_torch.speculative.split`); and the split
directory through the port's `load_drafter` on the tiny llama target.
"""

import json
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_vlm_tpu.speculative import split as js
from mlx_vlm_tpu_torch.speculative import split as ts
from mlx_vlm_tpu_torch.utils.loader import read_safetensors
from test_drafter_split import D, I, V, _mtp_tensors, _write_source

torch.set_num_threads(2)


def _read_jax(path) -> dict:
    from safetensors.numpy import load_file

    return load_file(str(path))


def _read_port(path) -> dict:
    out = {}
    for k, v in read_safetensors(path).items():
        if isinstance(v, torch.Tensor):  # BF16 -> ml_dtypes, as numpy reads
            v = v.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        out[k] = v
    return out


def _same_tensors(ref: dict, got: dict) -> None:
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype, k
        assert ref[k].shape == got[k].shape, k
        assert ref[k].tobytes() == got[k].tobytes(), k


@pytest.mark.parametrize("family", sorted(js.SPLIT_RULES))
def test_rules_match_jax(family):
    r, t = js.SPLIT_RULES[family], ts.SPLIT_RULES[family]
    assert sorted(ts.SPLIT_RULES) == sorted(js.SPLIT_RULES)
    assert (t.drafter_type, t.prefixes, t.extras) == (r.drafter_type,
                                                      r.prefixes, r.extras)
    cfg = {"text_config": {"num_hidden_layers": 46}}
    for key in ("mtp.layers.0.self_attn.q_proj.weight",
                "mtp.shared_head.norm.weight", "mtp.shared_head.head.weight",
                "model.mtp.block.mlp.up_proj.weight", "mtp.final_layernorm.b",
                "model.layers.46.eh_proj.weight",
                "model.layers.45.eh_proj.weight", "model.llm.norm.weight",
                "model.mtp.mtp_block.x", "lm_head.weight"):
        assert t.wanted(key, cfg) == r.wanted(key, cfg), key
        assert t.strip(key, cfg) == r.strip(key, cfg), key
    assert ts.resolve_rule(family).drafter_type == r.drafter_type
    with pytest.raises(ValueError):
        ts.resolve_rule("llama")


def _source(tmp_path, family: str, sharded: bool, bf16: bool):
    """A source checkpoint of `family`, one file or an index of two
    shards, its float tensors f32 or bf16."""
    from safetensors.numpy import save_file

    prefix = {"inkling": "model.mtp.", "glm4_moe": "model.layers.2.",
              "glm4_moe_lite": "model.layers.2.",
              "deepseek_v3": "model.layers.2."}.get(family, "mtp.")
    extra = ({"model.llm.norm.weight": np.full(D, 2.0, np.float32)}
             if family == "inkling" else None)
    src = _write_source(tmp_path, model_type=family, prefix=prefix,
                        extra=extra)
    if not (sharded or bf16):
        return src
    tensors = _read_jax(src / "model.safetensors")
    if bf16:
        tensors = {k: v.astype(ml_dtypes.bfloat16) for k, v in
                   tensors.items()}
    (src / "model.safetensors").unlink()
    keys = sorted(tensors)
    if sharded:
        halves = {"a.safetensors": keys[::2], "b.safetensors": keys[1::2]}
        for fn, ks in halves.items():
            save_file({k: tensors[k] for k in ks}, str(src / fn))
        (src / "model.safetensors.index.json").write_text(json.dumps({
            "weight_map": {k: fn for fn, ks in halves.items() for k in ks}}))
    else:
        save_file(tensors, str(src / "model.safetensors"))
    return src


@pytest.mark.parametrize("family", sorted(js.SPLIT_RULES))
@pytest.mark.parametrize("sharded,bf16", [(False, False), (True, False),
                                          (False, True)])
def test_split_output_matches_jax(tmp_path, family, sharded, bf16):
    src = _source(tmp_path, family, sharded, bf16)
    ref = js.split_drafter(str(src), str(tmp_path / "jax"))
    got = ts.split_drafter(str(src), str(tmp_path / "port"))
    assert (got / "config.json").read_text() == \
        (ref / "config.json").read_text()
    _same_tensors(_read_jax(ref / "model.safetensors"),
                  _read_port(got / "model.safetensors"))
    # the port's file reads the same through the safetensors package
    _same_tensors(_read_jax(ref / "model.safetensors"),
                  _read_jax(got / "model.safetensors"))
    assert sorted(p.name for p in got.iterdir()) == \
        sorted(p.name for p in ref.iterdir())
    assert ts.verify_split(str(src), str(got)) == \
        js.verify_split(str(src), str(ref))


def test_verify_detects_corruption(tmp_path):
    from mlx_vlm_tpu_torch.utils.loader import write_safetensors

    src = _source(tmp_path, "qwen3_5", False, False)
    out = ts.split_drafter(str(src), str(tmp_path / "drafter"))
    tensors = read_safetensors(out / "model.safetensors")
    tensors["model.enorm.weight"] = tensors["model.enorm.weight"] + 1
    write_safetensors(out / "model.safetensors", tensors)
    with pytest.raises(ValueError, match="parity failed"):
        ts.verify_split(str(src), str(out))
    with pytest.raises(ValueError, match="parity failed"):
        js.verify_split(str(src), str(out))


def test_no_tensors_refused(tmp_path):
    src = _source(tmp_path, "qwen3_5", False, False)
    for mod in (js, ts):
        with pytest.raises(ValueError, match="no drafter tensors"):
            mod.split_drafter(str(src), str(tmp_path / "x"),
                              family="inkling")


def test_command_line(tmp_path):
    src = _source(tmp_path, "qwen3_5", False, False)
    out = tmp_path / "cli"
    r = subprocess.run([sys.executable, "-m",
                        "mlx_vlm_tpu_torch.speculative.split", "--model",
                        str(src), "--output", str(out), "--verify"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "parity ok: 13 tensors" in r.stdout
    ref = js.split_drafter(str(src), str(tmp_path / "jax"))
    _same_tensors(_read_jax(ref / "model.safetensors"),
                  _read_port(out / "model.safetensors"))


def test_split_output_loads_and_drafts(tmp_path):
    """The split directory loads through the port's load_drafter against
    the tiny llama target (hidden 64, intermediate 128, vocab 256, the
    tensors' widths): an MTP drafter bound to the target's table, whose
    3 draft steps advance its cursor by 3."""
    from mlx_vlm_tpu_torch.speculative.drafters import load_drafter
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.testing import (llama_hf_weights,
                                                 tiny_llama_config)

    src = _source(tmp_path, "qwen3_5", False, False)
    out = ts.split_drafter(str(src), str(tmp_path / "drafter"))
    cfg = tiny_llama_config(hidden_size=D, intermediate_size=I,
                            vocab_size=V)
    target = load_model_from_weights(cfg, llama_hf_weights(cfg, 3),
                                     torch.float32, "cpu")
    drafter, params, kind = load_drafter(str(out), target, device="cpu")
    assert kind == "mtp" and drafter.target is not None
    assert "embed_tokens" not in params and "lm_head" not in params
    cache = drafter.init_cache(1, 64)
    toks = drafter.draft_fn(3)(params, cache, torch.tensor([5]),
                               torch.zeros((1, D)),
                               torch.zeros((), dtype=torch.int32))
    assert toks.shape == (1, 3) and int(cache.offset) == 3


def test_mtp_tensors_are_the_reference_helpers():
    t = _mtp_tensors("mtp.", np.random.default_rng(0))
    assert len(t) == 13 and t["mtp.eh_proj.weight"].shape == (D, 2 * D)
