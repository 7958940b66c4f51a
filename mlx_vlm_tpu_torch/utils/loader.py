"""Model loading: checkpoints -> torch parameter trees.

Port of mlx_vlm_tpu/utils/loader.py (get_model_and_args :125,
load_config :107, _nest :143, _stack_layers :154, runtime_quant_mode :290,
_fold_quantized :323, _to_device :375, load_model_from_weights :548,
load_model :759, load :773) for the qwen2_vl, qwen2_5_vl, qwen3_vl,
qwen3_vl_moe, llama, llava and paligemma families (PaliGemma's gemma and
gemma2 text models), the text MoE decoders (qwen2_moe, which qwen3_moe
maps to, mixtral, olmoe, phimoe, granitemoe), gpt_oss and the classic
decoders on models/classic_base.py (gpt2, gpt_neox, gpt_bigcode, phi,
phixtral, qwen, stablelm, starcoder2, nemotron), each picked by its config's
model_type (after the reference's remapping, `MODEL_REMAPPING`), and the
text-only fallback (models/text_only.py) for mistral and the other
llama-architecture text checkpoints and for gemma and gemma2.
Safetensors are parsed in numpy (bfloat16 read as uint16 and viewed as
torch.bfloat16), so loading needs neither `safetensors` nor `ml_dtypes`.  mlx group-affine triples fold by the
runtime mode (MLX_VLM_TPU_RUNTIME_QUANT, the reference's default rule when
unset): "w4grp" keeps 4-bit linears bit-exact in the halves-packed
Int4GroupedTensor layout and requantizes the rest to per-channel int8,
"w8chan" requantizes every 2-D triple to per-channel int8 and "exact" keeps
every triple as a QuantizedTensor in the mlx byte layout (a tied
embedding table, PaliGemma's and Gemma's, folds by the same rule: the
head reads the table it gathers from, per-channel int8 or K5's codes); a
3-D triple (a stack of experts) stays exact in every mode, as in the
reference (:362-366),
and per-path entries of the quantization config (an 8-bit router beside
4-bit linears) set a triple's own bits and group.  The entries are keyed by
the checkpoint's names; a model whose `sanitize` renames a quantized weight
(mixtral's `block_sparse_moe.gate` becomes `mlp.gate`) renames its entries
the same way (`rename_key`), where the reference probes the sanitized name
alone and misses them (ROADMAP Queue 3).  The unset mode
is w4grp only for a 4-bit checkpoint whose language model has the fused
decode step (`supports_fused_decode`: Qwen2-VL's, which Qwen2.5-VL
shares), else w8chan, as in the reference.  Per-layer weights are stacked
on a leading axis.  The whole-stack fused decode route is
decided at load time, as the reference decides whether to build its pack
(:655, :697): on unless MLX_VLM_TPU_FUSED_DECODE is 0 or false, and only for
a language model with `supports_fused_decode` whose weights pass the
reference's eligibility rule (w4grp layers only; an exact or w8chan model
decodes per linear).  No pack is built: the fused
kernel reads the same stacked weights as the per-linear path.

`params_from_jax` carries a parameter tree of the JAX package (numpy
leaves) over to the port unchanged, so tests run both on the same weights.
A JAX tree that holds a fused-decode pack gets its per-linear layers back
from the pack (the reference's `stacked_params_from_pack`).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.quant import (
    ChannelQuantizedTensor,
    Int4GroupedTensor,
    QuantizedTensor,
    from_mlx_packed,
    to_channel_quantized,
    to_int4_grouped,
)

__all__ = [
    "load",
    "load_model",
    "load_model_from_weights",
    "load_config",
    "read_safetensors",
    "read_safetensors_metadata",
    "safetensors_keys",
    "write_safetensors",
    "params_from_jax",
    "runtime_quant_mode",
    "decide_fused_decode",
]

# safetensors dtype -> numpy dtype (BF16 is read as uint16 and re-viewed)
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def get_model_path(path: str) -> Path:
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(
            f"Model path {path} not found (the port loads local checkpoints "
            "only)")
    return p


def load_config(model_path: Path) -> dict:
    """config.json merged with generation_config.json's token ids."""
    with open(model_path / "config.json") as f:
        config = json.load(f)
    gen_cfg_path = model_path / "generation_config.json"
    if gen_cfg_path.exists():
        try:
            with open(gen_cfg_path) as f:
                gen = json.load(f)
            for k in ("eos_token_id", "bos_token_id", "pad_token_id"):
                if k in gen and k not in config:
                    config[k] = gen[k]
        except (json.JSONDecodeError, OSError):
            pass
    return config


# the model types the port has, each its own package under models/
PORTED_MODEL_TYPES = ("qwen2_vl", "qwen2_5_vl", "qwen3_vl",
                      "qwen3_vl_moe", "llama", "llava", "paligemma",
                      "qwen2_moe", "mixtral", "olmoe", "phimoe",
                      "granitemoe", "gpt_oss", "gpt2", "gpt_neox",
                      "gpt_bigcode", "phi", "phixtral", "qwen", "stablelm",
                      "starcoder2", "nemotron")

# model_type -> module overrides: the reference's entries (:42-75) for the
# ported families
MODEL_REMAPPING = {
    "llava_next": "llava",  # CLIP tower + llama decoder path
    "qwen3": "llama",  # qk-norm + head_dim picked up from keys/config
    "qwen2": "llama",  # text-only qwen2 checkpoints (biases via keys)
    "qwen3_moe": "qwen2_moe",  # same MoE decoder; q/k norms picked up
}


def get_model_and_args(config: dict):
    """(model package, model type) for config["model_type"] (reference
    :125-136): the type remapped, its package when the port has it, else
    the text-only fallback for a text config of its architectures
    (models/text_only.py); any other type raises."""
    model_type = MODEL_REMAPPING.get(config["model_type"],
                                     config["model_type"])
    if model_type in PORTED_MODEL_TYPES:
        return importlib.import_module(
            f"mlx_vlm_tpu_torch.models.{model_type}"), model_type
    from ..models import text_only

    if text_only.is_text_only_config(config):
        text_only.text_arch(model_type)
        return text_only, model_type
    raise NotImplementedError(
        f"model type {model_type} is not ported (the port has "
        f"{', '.join(PORTED_MODEL_TYPES)} and text-only llama, mistral, "
        f"qwen2, qwen3, gemma and gemma2)")


def _bf16_tensor(u16: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(u16)).view(torch.bfloat16)


def safetensors_keys(path) -> list:
    """The tensor names of one .safetensors file, in header order."""
    with open(path, "rb") as fh:
        (hlen,) = struct.unpack("<Q", fh.read(8))
        return [k for k in json.loads(fh.read(hlen)) if k != "__metadata__"]


def read_safetensors(path, keys=None) -> dict:
    """The tensors of one .safetensors file (those named in `keys`, or
    all): numpy arrays, except BF16 tensors, which come back as CPU
    torch.bfloat16 tensors."""
    out = {}
    with open(path, "rb") as fh:
        (hlen,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(hlen))
        base = 8 + hlen
        for key, meta in header.items():
            if key == "__metadata__" or (keys is not None
                                         and key not in keys):
                continue
            dt = _ST_DTYPES.get(meta["dtype"])
            if dt is None:
                raise NotImplementedError(
                    f"{key}: safetensors dtype {meta['dtype']} is not supported")
            start, end = meta["data_offsets"]
            fh.seek(base + start)
            arr = np.frombuffer(fh.read(end - start), dtype=dt).reshape(
                meta["shape"]).copy()
            out[key] = _bf16_tensor(arr) if meta["dtype"] == "BF16" else arr
    return out


def read_safetensors_metadata(path) -> dict:
    """The `__metadata__` strings of one .safetensors file ({} when none)."""
    with open(path, "rb") as fh:
        (hlen,) = struct.unpack("<Q", fh.read(8))
        return dict(json.loads(fh.read(hlen)).get("__metadata__") or {})


def write_safetensors(path, tensors: dict, metadata: Optional[dict] = None,
                      bf16: tuple = ()) -> None:
    """Write numpy arrays as one .safetensors file (the layout that
    `safetensors.numpy.save_file` writes: a little-endian header length,
    the JSON header padded with spaces to 8 bytes, the tensors' bytes in
    header order), with string `metadata`.  The arrays named in `bf16`
    are uint16 arrays that hold bfloat16 bits and are written as BF16."""
    names = {np.dtype(v): k for k, v in _ST_DTYPES.items() if k != "BF16"}
    header, blobs, at = {}, [], 0
    for key, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        dtype = "BF16" if key in bf16 else names[arr.dtype]
        header[key] = {"dtype": dtype, "shape": list(arr.shape),
                       "data_offsets": [at, at + arr.nbytes]}
        blobs.append(arr.tobytes())
        at += arr.nbytes
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for b in blobs:
            fh.write(b)


def _read_checkpoint(model_path: Path) -> dict:
    files = sorted(model_path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"No safetensors found in {model_path}")
    weights = {}
    for f in files:
        weights.update(read_safetensors(f))
    return weights


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


# the array fields of each container, stacked along a new leading axis
_DATA_FIELDS = {
    Int4GroupedTensor: ("qp", "sl", "sh", "bl", "bh"),
    QuantizedTensor: ("q", "scales", "biases"),
    ChannelQuantizedTensor: ("q8", "scales", "biases"),
}


def _stack(vals: list, dest: int = 0):
    """The arrays stacked on a new axis at `dest`."""
    if isinstance(vals[0], torch.Tensor):
        return torch.movedim(torch.stack(vals), 0, dest)
    return np.moveaxis(np.stack(vals), 0, dest)


def _stack_layers(flat: dict, patterns) -> dict:
    """Fold `prefix.{i}.rest` keys into stacked leaves keyed `prefix.rest`.
    Patterns apply in order; an entry `(prefix, dest_axis)` puts the new
    axis at dest_axis (per-layer expert stacks, already stacked over the
    layers, become [L, E, ...] with dest_axis 1)."""
    for pat in patterns:
        pref, dest = pat if isinstance(pat, (tuple, list)) else (pat, 0)
        pr = re.compile(rf"^{re.escape(pref)}\.(\d+)\.(.+)$")
        out = {}
        groups: dict = {}
        for k, v in flat.items():
            m = pr.match(k)
            if m:
                groups.setdefault(m.group(2), {})[int(m.group(1))] = v
            else:
                out[k] = v
        for rest, items in groups.items():
            vals = [items[i] for i in sorted(items)]
            if len(vals) != max(items) + 1:
                raise ValueError(f"missing indices under {pref}.*.{rest}")
            v0 = vals[0]
            if type(v0) in _DATA_FIELDS:
                stacked = dataclasses.replace(
                    v0, **{f: _stack([getattr(t, f) for t in vals], dest)
                           for f in _DATA_FIELDS[type(v0)]})
            else:
                stacked = _stack(vals, dest)
            out[f"{pref}.{rest}"] = stacked
        flat = out
    return flat


def runtime_quant_mode(default: str = "w8chan") -> str:
    """How quantized weights run: MLX_VLM_TPU_RUNTIME_QUANT, else `default`.

    "w4grp": 4-bit linears bit-exact in the halves-packed Int4GroupedTensor
    layout (K1 / K2 / K3); "w8chan": per-channel int8 [K, N]
    (ChannelQuantizedTensor, plain tensor math); "exact": the checkpoint's
    mlx codes as they are (QuantizedTensor, K5)."""
    mode = os.environ.get("MLX_VLM_TPU_RUNTIME_QUANT", "") or default
    if mode not in ("w4grp", "w8chan", "exact"):
        raise ValueError(
            f"MLX_VLM_TPU_RUNTIME_QUANT must be w4grp|w8chan|exact, "
            f"got {mode}")
    return mode


def _fold_workers() -> int:
    """Host threads of w4grp's int4 repacks: the cores this process may
    use, at most 8."""
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:
        n = os.cpu_count() or 1
    return max(1, min(8, n))


def _fold_triple(w: np.ndarray, scales, biases, bits: int, group_size: int,
                 mode: str, is_embed: bool, device=None):
    """One mlx triple in the runtime `mode`'s layout: Int4GroupedTensor for
    an eligible 4-bit linear under w4grp, ChannelQuantizedTensor for other
    2-D triples under w4grp and w8chan (requantized on `device`, the
    load's), else the QuantizedTensor as it is.  Eligible: the reference's
    rule (whole groups a row) and a group size that K1 and K2 take (a
    multiple of 16); the reference's fold repacks any group size (ROADMAP
    Queue 3, divergences)."""
    qt = from_mlx_packed(w, scales, biases, bits, group_size)
    if (mode == "w4grp" and bits == 4 and qt.q.ndim == 2 and not is_embed
            and (qt.q.shape[1] * 2) % group_size == 0
            and group_size % 16 == 0):
        return to_int4_grouped(qt)
    if mode in ("w8chan", "w4grp") and qt.q.ndim == 2:
        return to_channel_quantized(qt, device=device)
    return qt


def _fold_quantized(flat: dict, qcfg: dict,
                    default_mode: str = "w8chan", device=None) -> dict:
    """Fold mlx-style (weight: packed uint32, scales, biases) triples by the
    runtime mode: under "w4grp" eligible 4-bit linears -> Int4GroupedTensor
    and other 2-D triples (embedding tables included) ->
    ChannelQuantizedTensor; under "w8chan" every 2-D triple ->
    ChannelQuantizedTensor; under "exact" every triple stays a
    QuantizedTensor.  The triples are independent: the int4 repacks run on
    a pool of host threads (`_fold_workers`), while each per-channel
    requantization runs as torch float64 ops on `device` (the load's; the
    CPU when None), so that a load onto the card folds there."""
    bits = qcfg.get("bits", 4)
    group_size = qcfg.get("group_size", 64)
    mode = runtime_quant_mode(default_mode)
    out = {}
    handled = set()
    jobs = []  # (weight key, the triple's arguments to _fold_triple)
    for k in list(flat.keys()):
        if not k.endswith(".scales"):
            continue
        base = k[: -len(".scales")]
        wk, bk = base + ".weight", base + ".biases"
        if wk not in flat:
            continue
        # per-path overrides are keyed by checkpoint names; sanitize() may
        # have prefixed them, so probe with leading components stripped
        probe = base
        per = qcfg.get(probe, None)
        while per is None and "." in probe:
            probe = probe.split(".", 1)[1]
            per = qcfg.get(probe, None)
        b, g = bits, group_size
        if isinstance(per, dict):
            b, g = per.get("bits", bits), per.get("group_size", group_size)
        if per is False:
            continue
        w = flat[wk]
        if not (isinstance(w, np.ndarray) and w.dtype == np.uint32):
            continue
        biases = flat.get(bk)
        if biases is None:
            biases = np.zeros_like(flat[k]) if isinstance(flat[k], np.ndarray) \
                else torch.zeros_like(flat[k])
        is_embed = any(n in base for n in ("embed_tokens", "wte", "wpe"))
        jobs.append((wk, (w, flat[k], biases, b, g, mode, is_embed)))
        handled.update({wk, k, bk})
    with ThreadPoolExecutor(_fold_workers()) as pool:
        # int4 repacks go to the pool; the requantizations run here, on
        # the device, meanwhile
        pending = {}
        for wk, args in jobs:
            if mode == "w4grp" and args[3] == 4 and not args[6]:
                pending[wk] = pool.submit(_fold_triple, *args)
            else:
                out[wk] = _fold_triple(*args, device=device)
        for wk, f in pending.items():
            out[wk] = f.result()
    out = {wk: out[wk] for wk, _ in jobs}  # the checkpoint's key order
    for k, v in flat.items():
        if k not in handled:
            out.setdefault(k, v)
    return out


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. arrays exported by JAX: copy, as torch
        a = a.copy()           # tensors may be written
    if a.dtype.name == "bfloat16":
        return _bf16_tensor(a.view(np.uint16))
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_device(flat: dict, dtype: torch.dtype, device) -> dict:
    name = str(dtype).removeprefix("torch.")

    def put(v):
        if isinstance(v, Int4GroupedTensor):
            return Int4GroupedTensor(
                qp=_as_tensor(v.qp).to(device),
                **{f: _as_tensor(getattr(v, f)).to(device, torch.float32)
                   for f in ("sl", "sh", "bl", "bh")},
                n=v.n, group_size=v.group_size, out_dtype=name)
        if isinstance(v, ChannelQuantizedTensor):
            return ChannelQuantizedTensor(
                q8=_as_tensor(v.q8).to(device),
                scales=_as_tensor(v.scales).to(device, dtype),
                biases=_as_tensor(v.biases).to(device, dtype),
                src_bits=v.src_bits,
                out_dtype=name)
        if isinstance(v, QuantizedTensor):
            return QuantizedTensor(
                q=_as_tensor(v.q).to(device, torch.uint8),
                scales=_as_tensor(v.scales).to(device, dtype),
                biases=_as_tensor(v.biases).to(device, dtype),
                bits=v.bits, group_size=v.group_size, out_dtype=name)
        t = _as_tensor(v)
        if t.is_floating_point():
            return t.to(device, dtype)
        return t.to(device)

    return {k: put(v) for k, v in flat.items()}


def _check_device(device, dtype: torch.dtype) -> torch.device:
    """The device to load onto; the card unless the caller asks for the CPU.
    Raises before any work when the card would not take `dtype` (its
    kernels K1, K4 and K5 take bfloat16 only) or is one this host lacks."""
    device = torch.device(device)
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA kernels (K1, K4, K5) take torch.bfloat16, not {dtype}: "
            "load onto the GPU with dtype=torch.bfloat16, or pass "
            "device='cpu' for other dtypes")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the model loads onto the GPU unless the caller "
            "passes device='cpu'")
    return device


def load_model_from_weights(config: dict, weights: dict,
                            dtype: torch.dtype = torch.bfloat16,
                            device="cuda"):
    """Full load pipeline from an in-memory flat weight dict (HF keys):
    sanitize -> quant fold -> layer stacking -> device."""
    device = _check_device(device, dtype)
    arch, _ = get_model_and_args(config)
    model = arch.Model(arch.ModelConfig.from_dict(config))
    qc = config.get("quantization_config") or {}
    if qc.get("quant_method") == "compressed-tensors":
        raise NotImplementedError("compressed-tensors checkpoints are not ported")
    weights = model.sanitize(weights)
    qcfg = config.get("quantization")
    if qcfg:
        # the reference's default (:566-577): w4grp for a 4-bit checkpoint
        # whose language model has the fused decode step, else w8chan
        fused_ok = (getattr(model.language_model, "supports_fused_decode",
                            False) and qcfg.get("bits", 4) == 4)
        weights = _fold_quantized(weights, _renamed_entries(model, qcfg),
                                  "w4grp" if fused_ok else "w8chan", device)
    weights = _stack_layers(weights, tuple(model.stack_patterns))
    model.params = _nest(_to_device(weights, dtype, device))
    model.config_dict = config
    model.device = device
    decide_fused_decode(model)
    return model


def _renamed_entries(model, qcfg: dict) -> dict:
    """The quantization config with its per-path entries (checkpoint names)
    renamed as the model's `sanitize` renames the weights they describe
    (`rename_key`, where a model has one), so that the fold finds them
    under the sanitized keys."""
    rename = getattr(model, "rename_key", None)
    if rename is None:
        return qcfg
    return {(rename(k + ".")[:-1] if isinstance(v, dict) or v is False
             else k): v for k, v in qcfg.items()}


def decide_fused_decode(model) -> bool:
    """Turn the language model's whole-stack fused decode route on when
    MLX_VLM_TPU_FUSED_DECODE allows it (default on) and its weights are
    eligible; returns the decision."""
    from ..ops.fused_decode import fused_decode_eligible

    lm = model.language_model
    lm.fused_decode = (
        getattr(lm, "supports_fused_decode", False)
        and os.environ.get("MLX_VLM_TPU_FUSED_DECODE", "1") not in ("0", "false")
        and fused_decode_eligible(model.params["language_model"], lm.args,
                                  model.device))
    return lm.fused_decode


def load_model(model_path, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """Instantiate the model and attach its parameter tree."""
    device = _check_device(device, dtype)
    model_path = Path(model_path)
    config = load_config(model_path)
    return load_model_from_weights(config, _read_checkpoint(model_path), dtype,
                                   device)


def load(path: str, processor_kwargs: Optional[dict] = None,
         dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """Load (model, processor) from a local checkpoint directory."""
    device = _check_device(device, dtype)
    model_path = get_model_path(path)
    model = load_model(model_path, dtype=dtype, device=device)
    from .processing import load_processor

    processor = load_processor(model_path, model, **(processor_kwargs or {}))
    return model, processor


def params_from_jax(model, params: dict) -> dict:
    """The port's parameter tree for `model` from a JAX-package tree.

    `params` is the JAX package's `model.params` with numpy leaves (e.g.
    `jax.tree_util.tree_map(np.asarray, params)`): stacked dense arrays and
    Int4GroupedTensor / QuantizedTensor / ChannelQuantizedTensor containers
    of numpy fields.
    Containers are recognised by their fields, so the JAX package is not
    imported; adapter factors (`lora_a`, `lora_b`, `dora_m`) and gpt-oss's
    sinks are dense leaves like any other, and the classic decoders'
    layers keep their `attn` key.  Every byte and value is kept; tensors land on the CPU.  A
    fused-decode pack (the JAX default for int4 weights) is not part of the
    port's layout: the per-linear layers it replaced are rebuilt from it
    when the tree has none, and the pack is dropped."""

    def convert(v, path):
        if isinstance(v, dict):
            v = dict(v)
            pack = v.pop("fused_decode", None)
            if pack is not None:
                mdl = v["model"] = dict(v["model"])
                mdl.setdefault("layers", _stacked_params_from_pack(pack))
            return {k: convert(x, f"{path}.{k}" if path else k)
                    for k, x in v.items()}
        if hasattr(v, "qp") and hasattr(v, "sl"):
            return Int4GroupedTensor(
                **{f: _as_tensor(getattr(v, f))
                   for f in ("qp", "sl", "sh", "bl", "bh")},
                n=int(v.n), group_size=int(v.group_size),
                out_dtype=str(v.out_dtype))
        if hasattr(v, "q8"):
            return ChannelQuantizedTensor(
                q8=_as_tensor(v.q8), scales=_as_tensor(v.scales),
                biases=_as_tensor(v.biases), src_bits=int(v.src_bits),
                out_dtype=str(v.out_dtype))
        if all(hasattr(v, f) for f in ("q", "scales", "biases", "bits",
                                       "group_size", "out_dtype")):
            return QuantizedTensor(
                q=_as_tensor(v.q), scales=_as_tensor(v.scales),
                biases=_as_tensor(v.biases), bits=int(v.bits),
                group_size=int(v.group_size), out_dtype=str(v.out_dtype))
        if isinstance(v, (np.ndarray, np.generic)):
            return _as_tensor(v)
        raise TypeError(f"{path}: unsupported leaf {type(v).__name__}")

    out = convert(params, "")
    layers = out["language_model"]["model"]["layers"]
    q = layers["self_attn" if "self_attn" in layers else "attn"]["q_proj"][
        "weight"]
    if not isinstance(q, torch.Tensor):
        q = getattr(q, _DATA_FIELDS[type(q)][0])
    n_layers = q.shape[0]
    if n_layers != model.decoder_layers:
        raise ValueError(f"params hold {n_layers} decoder layers, the model "
                         f"{model.decoder_layers}")
    return out


def _stacked_params_from_pack(pack) -> dict:
    """The stacked per-linear layer tree (numpy Int4GroupedTensor fields)
    from a JAX fused-decode pack with numpy leaves: the reference's
    `stacked_params_from_pack` (mlx_vlm_tpu/ops/fused_decode.py:478-572),
    a pure relayout, so every byte and value is kept."""
    g, od = int(pack.group_size), str(pack.out_dtype)
    D, I = int(pack.dim), int(pack.inter)
    nkv = int(pack.n_kv) * int(pack.head_dim)
    nq2, nk2, nv2 = int(pack.nq2), int(pack.nk2), int(pack.nv2)

    def planes(sc):
        sc = np.asarray(sc)
        if sc.dtype == np.uint16:  # f16-bit planes -> exact f32
            sc = sc.view(np.float16).astype(np.float32)
        return sc

    def untile(qp, sc):
        # [L, NT, K, TN] -> [L, K, C];  [L, NT, G, 4, TN] -> [L, G, 4, C]
        qp, sc = np.asarray(qp), planes(sc)
        L, NT, K, TN = qp.shape
        qp = qp.transpose(0, 2, 1, 3).reshape(L, K, NT * TN)
        sc = sc.transpose(0, 2, 3, 1, 4).reshape(L, sc.shape[2], 4, NT * TN)
        return qp, sc

    def tensor(qp, sc, c0, w, n):
        p = [np.ascontiguousarray(sc[:, :, k, c0:c0 + w][:, :, None, :])
             for k in range(4)]
        return Int4GroupedTensor(
            qp=np.ascontiguousarray(qp[:, :, c0:c0 + w]), sl=p[0], sh=p[1],
            bl=p[2], bh=p[3], n=n, group_size=g, out_dtype=od)

    qp, sc = untile(pack.qkv_qp, pack.qkv_sc)
    wq = tensor(qp, sc, 0, nq2, D)
    wk = tensor(qp, sc, nq2, nk2, nkv)
    wv = tensor(qp, sc, nq2 + nk2, nv2, nkv)
    bias = np.asarray(pack.qkv_bias)  # [L, 2, Cq] lo / hi planes

    def seg_bias(c0, w, n):
        return np.ascontiguousarray(np.concatenate(
            [bias[:, 0, c0:c0 + w], bias[:, 1, c0:c0 + w]], axis=-1)[:, :n])

    qp, sc = untile(pack.o_qp, pack.o_sc)
    wo = tensor(qp, sc, 0, int(pack.no2), D)
    qp, sc = untile(pack.gu_qp, pack.gu_sc)
    ng2 = int(pack.ng2)
    wg = tensor(qp, sc, 0, ng2, I)
    wu = tensor(qp, sc, ng2, qp.shape[-1] - ng2, I)
    dqp = np.asarray(pack.dn_qp)  # [L, ND, TKD, Cd]
    L, ND, TKD, Cd = dqp.shape
    dsc = planes(pack.dn_sc).reshape(L, ND * TKD // g, 4, Cd)
    wd = tensor(dqp.reshape(L, ND * TKD, Cd), dsc, 0, Cd, D)
    norms = np.asarray(pack.norms)  # [L, 2, D]
    return {
        "input_layernorm": {"weight": np.ascontiguousarray(norms[:, 0])},
        "post_attention_layernorm": {
            "weight": np.ascontiguousarray(norms[:, 1])},
        "self_attn": {
            "q_proj": {"weight": wq, "bias": seg_bias(0, nq2, D)},
            "k_proj": {"weight": wk, "bias": seg_bias(nq2, nk2, nkv)},
            "v_proj": {"weight": wv, "bias": seg_bias(nq2 + nk2, nv2, nkv)},
            "o_proj": {"weight": wo},
        },
        "mlp": {
            "gate_proj": {"weight": wg},
            "up_proj": {"weight": wu},
            "down_proj": {"weight": wd},
        },
    }
