"""Streaming detokenization.

Copied unchanged from mlx_vlm_tpu/utils/tokenizer.py (it imports no jax;
`transformers` is imported only inside `load_tokenizer`).
Role parity: reference `mlx_vlm/tokenizer_utils.py` — StreamingDetokenizer:19,
SPMStreamingDetokenizer:121, BPEStreamingDetokenizer:200 (byte-level
incremental decode), detokenizer selection by decoder introspection:424-451,
load_tokenizer:453.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional

__all__ = [
    "StreamingDetokenizer",
    "NaiveStreamingDetokenizer",
    "BPEStreamingDetokenizer",
    "SPMStreamingDetokenizer",
    "make_detokenizer",
    "load_tokenizer",
]

_REPLACEMENT = "�"


@lru_cache(maxsize=1)
def _byte_level_table():
    """GPT-2 byte<->unicode table (the standard byte-level BPE mapping)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class NaiveStreamingDetokenizer:
    """Windowed full-decode fallback (reference tokenizer_utils.py:19)."""

    def __init__(self, tokenizer, skip_special_tokens: bool = False):
        self.tokenizer = tokenizer
        self.skip_special_tokens = skip_special_tokens
        self._ids: List[int] = []
        self._emitted = ""
        self.text = ""

    def reset(self):
        self._ids, self._emitted, self.text = [], "", ""

    def add_token(self, token: int):
        self._ids.append(int(token))

    def last_segment(self) -> str:
        s = self.tokenizer.decode(
            self._ids, skip_special_tokens=self.skip_special_tokens
        )
        if s.endswith(_REPLACEMENT):
            return ""
        new = s[len(self._emitted) :]
        self._emitted = s
        self.text += new
        if s.endswith("\n"):
            self._ids, self._emitted = [], ""
        return new

    def finalize(self) -> str:
        s = self.tokenizer.decode(
            self._ids, skip_special_tokens=self.skip_special_tokens
        )
        new = s[len(self._emitted) :]
        self._emitted = s
        self.text += new
        return new


class BPEStreamingDetokenizer:
    """Incremental byte-level BPE decode — O(token length) per token
    (reference tokenizer_utils.py:200)."""

    def __init__(self, tokenizer, skip_special_tokens: bool = False):
        self.tokenizer = tokenizer
        self._byte_map = _byte_level_table()
        self._pending = bytearray()
        self._segment = ""
        self.text = ""
        self._skip_ids = (
            set(getattr(tokenizer, "all_special_ids", []) or [])
            if skip_special_tokens
            else set()
        )

    def reset(self):
        self._pending = bytearray()
        self._segment = ""
        self.text = ""

    def add_token(self, token: int):
        token = int(token)
        if token in self._skip_ids:
            return
        s = self.tokenizer.convert_ids_to_tokens(token)
        if s is None:
            return
        for ch in s:
            b = self._byte_map.get(ch)
            if b is None:
                self._pending.extend(ch.encode("utf-8"))
            else:
                self._pending.append(b)

    def last_segment(self) -> str:
        # emit the longest valid-utf8 prefix
        try:
            s = self._pending.decode("utf-8")
            self._pending = bytearray()
        except UnicodeDecodeError as e:
            if e.start == 0:
                return ""
            s = self._pending[: e.start].decode("utf-8")
            self._pending = self._pending[e.start :]
        self.text += s
        return s

    def finalize(self) -> str:
        s = self._pending.decode("utf-8", errors="replace")
        self._pending = bytearray()
        self.text += s
        return s


class SPMStreamingDetokenizer:
    """SentencePiece-style streaming decode (reference :121): ▁ -> space,
    <0xNN> byte pieces accumulated."""

    def __init__(self, tokenizer, trim_space: bool = True,
                 skip_special_tokens: bool = False):
        self.tokenizer = tokenizer
        self.trim_space = trim_space
        self._pending = bytearray()
        self._first = True
        self.text = ""
        self._segment = ""
        self._skip_ids = (
            set(getattr(tokenizer, "all_special_ids", []) or [])
            if skip_special_tokens
            else set()
        )

    def reset(self):
        self._pending = bytearray()
        self._first = True
        self.text = ""
        self._segment = ""

    def add_token(self, token: int):
        token = int(token)
        if token in self._skip_ids:
            return
        s = self.tokenizer.convert_ids_to_tokens(token)
        if s is None:
            return
        if s.startswith("<0x") and s.endswith(">") and len(s) == 6:
            self._pending.append(int(s[3:5], 16))
            return
        s = s.replace("▁", " ")
        if self._first and self.trim_space and s.startswith(" "):
            s = s[1:]
        self._first = False
        self._pending.extend(s.encode("utf-8"))

    def last_segment(self) -> str:
        try:
            s = self._pending.decode("utf-8")
            self._pending = bytearray()
        except UnicodeDecodeError as e:
            if e.start == 0:
                return ""
            s = self._pending[: e.start].decode("utf-8")
            self._pending = self._pending[e.start :]
        self.text += s
        return s

    def finalize(self) -> str:
        s = self._pending.decode("utf-8", errors="replace")
        self._pending = bytearray()
        self.text += s
        return s


def make_detokenizer(tokenizer, skip_special_tokens: bool = False):
    """Pick the streaming detokenizer by decoder introspection
    (reference tokenizer_utils.py:424-451)."""
    try:
        import json

        backend = getattr(tokenizer, "backend_tokenizer", None)
        if backend is not None:
            spec = json.loads(backend.to_str())
            dec = (spec.get("decoder") or {}).get("type", "")
            if dec == "ByteLevel":
                return BPEStreamingDetokenizer(tokenizer, skip_special_tokens)
            if dec == "Sequence":
                types = [
                    d.get("type")
                    for d in spec["decoder"].get("decoders", [])
                ]
                if "ByteFallback" in types or "Metaspace" in types:
                    return SPMStreamingDetokenizer(
                        tokenizer, skip_special_tokens=skip_special_tokens
                    )
            if dec == "Metaspace":
                return SPMStreamingDetokenizer(
                    tokenizer, skip_special_tokens=skip_special_tokens
                )
    except Exception:  # noqa: BLE001
        pass
    return NaiveStreamingDetokenizer(tokenizer, skip_special_tokens)


# default export used across the engine
StreamingDetokenizer = NaiveStreamingDetokenizer


def load_tokenizer(model_path, **kwargs):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(model_path), **kwargs)
