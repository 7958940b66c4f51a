"""Drafter checkpoint split tooling: extract MTP heads into standalone
drafter directories and check the result bit for bit.

Port of mlx_vlm_tpu/speculative/split.py (SplitRule :60, SPLIT_RULES :92,
resolve_rule :117, _extract :160, split_drafter :175, verify_split :215,
main :250).  One data-driven module for every family: a `SplitRule` per
family declares (drafter model_type, wanted-key prefixes, rename
overrides); the shared code streams the index's shards, renames to the
single-block drafter layout that drafters/mtp.py reads (enorm / hnorm /
eh_proj / layer.* / norm), writes config.json from the text config,
copies the tokenizer files, and re-derives the mapping from the source
to compare with what was written.  Host only: the port's own safetensors
reader and writer (utils/loader.py), so no `safetensors` package.

Usage:
    python -m mlx_vlm_tpu_torch.speculative.split --model <src> --output <dir>
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

__all__ = ["SPLIT_RULES", "SplitRule", "split_drafter", "verify_split",
           "resolve_rule", "main"]

# canonical single-block drafter layout renames, applied after the family
# prefix strip (drafters/mtp.py MTPDrafter's params)
_CANON = (
    (re.compile(r"^layers\.0\."), "layer."),
    (re.compile(r"^mtp_block\."), "layer."),
    (re.compile(r"^block\."), "layer."),
    (re.compile(r"^shared_head\.norm\."), "norm."),
    (re.compile(r"^shared_head\.head\."), "lm_head."),
    (re.compile(r"^final_layernorm\."), "norm."),
)


def _canonical(rest: str) -> str:
    for pat, repl in _CANON:
        rest = pat.sub(repl, rest)
    return rest


@dataclasses.dataclass(frozen=True)
class SplitRule:
    """One family's extraction recipe."""

    drafter_type: str
    prefixes: Tuple[str, ...]
    # source-key -> drafter-key overrides checked before prefix stripping
    extras: Tuple[Tuple[str, str], ...] = ()
    # the wanted prefix derived from the source config (glm's nextn layer)
    dynamic_prefix: Optional[Callable[[dict], str]] = None

    def _prefixes(self, config: dict) -> tuple:
        if self.dynamic_prefix is None:
            return self.prefixes
        return self.prefixes + (self.dynamic_prefix(config),)

    def wanted(self, key: str, config: dict) -> bool:
        if any(key == src for src, _ in self.extras):
            return True
        return any(key.startswith(p) for p in self._prefixes(config))

    def strip(self, key: str, config: dict) -> str:
        for src, dst in self.extras:
            if key == src:
                return dst
        for p in sorted(self._prefixes(config), key=len, reverse=True):
            if key.startswith(p):
                return "model." + _canonical(key[len(p):])
        return key


def _nextn_prefix(config: dict) -> str:
    tc = config.get("text_config") or config
    return f"model.layers.{int(tc.get('num_hidden_layers', 0))}."


SPLIT_RULES: Dict[str, SplitRule] = {
    # model.mtp.* and the LLM's final norm
    "inkling": SplitRule(
        "inkling_mtp", ("model.mtp.",),
        extras=(("model.llm.norm.weight", "model.norm.weight"),)),
    # top-level mtp.*
    "qwen3_5": SplitRule("qwen3_5_mtp", ("mtp.",)),
    "qwen3_5_moe": SplitRule("qwen3_5_mtp", ("mtp.",)),
    "deepseek_v4": SplitRule("deepseek_v4_mtp", ("mtp.",)),
    # the nextn layer model.layers.<num_hidden_layers>.* is the drafter
    "glm4_moe": SplitRule("glm4_moe_lite_mtp", (),
                          dynamic_prefix=_nextn_prefix),
    "glm4_moe_lite": SplitRule("glm4_moe_lite_mtp", (),
                               dynamic_prefix=_nextn_prefix),
    # DeepSeek-V3-style nextn checkpoints share the same layout
    "deepseek_v3": SplitRule("deepseek_v4_mtp", (),
                             dynamic_prefix=_nextn_prefix),
}


def resolve_rule(model_type: str) -> SplitRule:
    rule = SPLIT_RULES.get(model_type)
    if rule is None:
        raise ValueError(
            f"no drafter split rule for model_type {model_type!r}; "
            f"known: {sorted(SPLIT_RULES)}")
    return rule


# ----------------------------------------------------------- shard access
def _weight_map(model_path: Path) -> Dict[str, str]:
    idx = model_path / "model.safetensors.index.json"
    if not idx.exists():
        return {}
    return json.loads(idx.read_text()).get("weight_map", {})


def _iter_shards(model_path: Path, wanted) -> Iterable[Tuple[Path, list]]:
    """(shard file, wanted keys) pairs, index-aware, so that only the
    shards holding drafter tensors are opened."""
    from ..utils.loader import safetensors_keys

    wm = _weight_map(model_path)
    if wm:
        by_file: Dict[str, list] = {}
        for key, fn in wm.items():
            if wanted(key):
                by_file.setdefault(fn, []).append(key)
        for fn, keys in by_file.items():
            yield model_path / fn, keys
        return
    for f in sorted(model_path.glob("*.safetensors")):
        if f.name == "consolidated.safetensors":
            continue
        keys = [k for k in safetensors_keys(f) if wanted(k)]
        if keys:
            yield f, keys


def _host(a) -> Tuple[np.ndarray, bool]:
    """(numpy array, is bfloat16): BF16 tensors as their uint16 bits."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.view(torch.uint16).numpy(), True
    return a, False


def _extract(source_path: Path, rule: SplitRule, config: dict) -> dict:
    """{drafter key: (numpy array, is bfloat16)} of the rule's tensors."""
    from ..utils.loader import read_safetensors

    selected: dict = {}
    for f, keys in _iter_shards(source_path,
                                lambda k: rule.wanted(k, config)):
        for k, v in read_safetensors(f, set(keys)).items():
            selected[rule.strip(k, config)] = _host(v)
    return selected


# ----------------------------------------------------------------- split
def split_drafter(source: str, output: str,
                  family: Optional[str] = None) -> Path:
    """Extract one family's MTP drafter into a standalone directory that
    `speculative.drafters.load_drafter` loads."""
    from ..utils.loader import write_safetensors

    source_path = Path(source).expanduser()
    output_path = Path(output).expanduser()
    output_path.mkdir(parents=True, exist_ok=True)
    config = json.loads((source_path / "config.json").read_text())
    model_type = family or config.get("model_type", "")
    rule = resolve_rule(model_type)

    selected = _extract(source_path, rule, config)
    if not selected:
        raise ValueError(
            f"no drafter tensors matching {rule.prefixes} in {source_path}")
    write_safetensors(output_path / "model.safetensors",
                      {k: a for k, (a, _) in selected.items()},
                      bf16=tuple(k for k, (_, b) in selected.items() if b))

    tc = dict(config.get("text_config") or config)
    draft_config = {"model_type": rule.drafter_type,
                    "split_from": model_type}
    for k in ("hidden_size", "intermediate_size", "num_attention_heads",
              "num_key_value_heads", "vocab_size", "rms_norm_eps",
              "rope_theta", "tie_word_embeddings"):
        if k in tc:
            draft_config[k] = tc[k]
    (output_path / "config.json").write_text(
        json.dumps(dict(sorted(draft_config.items())), indent=2))

    for name in ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                 "merges.txt", "special_tokens_map.json"):
        src = source_path / name
        if src.exists():
            shutil.copy(src, output_path / name)
    return output_path


# ----------------------------------------------------------------- parity
def verify_split(source: str, drafter_dir: str,
                 family: Optional[str] = None) -> dict:
    """Bit-for-bit parity: re-derive the tensor mapping from the source
    and compare it with what the drafter directory holds.  Returns a
    report and raises ValueError on any mismatch."""
    from ..utils.loader import read_safetensors

    source_path = Path(source).expanduser()
    drafter_path = Path(drafter_dir).expanduser()
    config = json.loads((source_path / "config.json").read_text())
    rule = resolve_rule(family or config.get("model_type", ""))
    expected = _extract(source_path, rule, config)
    got = {k: _host(v) for k, v in
           read_safetensors(drafter_path / "model.safetensors").items()}

    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    mismatched = sorted(
        k for k in set(expected) & set(got)
        if expected[k][1] != got[k][1]
        or expected[k][0].dtype != got[k][0].dtype
        or expected[k][0].shape != got[k][0].shape
        or not np.array_equal(expected[k][0], got[k][0]))
    report = {
        "tensors": len(expected),
        "missing": missing,
        "extra": extra,
        "mismatched": mismatched,
        "ok": not (missing or extra or mismatched),
    }
    if not report["ok"]:
        raise ValueError(f"drafter split parity failed: {report}")
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Split a model's native MTP tensors into a standalone "
                    "drafter directory (--draft-model input).")
    parser.add_argument("--model", "--source", dest="source", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--family", default=None,
                        help="override the source model_type rule")
    parser.add_argument("--verify", action="store_true",
                        help="run the bitwise parity check after writing")
    args = parser.parse_args(argv)
    out = split_drafter(args.source, args.output, family=args.family)
    print(f"wrote drafter to {out}")
    if args.verify:
        report = verify_split(args.source, out, family=args.family)
        print(f"parity ok: {report['tensors']} tensors")


if __name__ == "__main__":
    main()
