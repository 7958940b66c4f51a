"""Gemma-4 tool calls (reference tool_parsers/gemma4.py).

Wire format::

    <|tool_call>call:get_weather{city:<|"|>Paris<|"|>,n:2}<tool_call|>

Keys are bare words; strings are <|"|>-delimited; objects/arrays nest with
braces/brackets; other literals are JSON.
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Tuple

START, END = "<|tool_call>", "<tool_call|>"
_BLOCK = re.compile(re.escape(START) + r"(.*?)" + re.escape(END), re.DOTALL)
_CALL = re.compile(r"(?:call:)?([\w.:-]+)\s*\{", re.DOTALL)
_Q = '<|"|>'


def _scan(text: str, i: int, stop_chars: str) -> int:
    """Index of the first top-level stop char at/after i (len(text) if
    none), skipping nested braces/brackets and <|"|>-escaped strings."""
    depth = 0
    while i < len(text):
        if text.startswith(_Q, i):
            j = text.find(_Q, i + len(_Q))
            i = len(text) if j == -1 else j + len(_Q)
            continue
        ch = text[i]
        if ch in "{[":
            depth += 1
        elif ch in "}]":
            if depth == 0 and ch in stop_chars:
                return i
            depth -= 1
        elif depth == 0 and ch in stop_chars:
            return i
        i += 1
    return len(text)


def _parse_value(text: str) -> Any:
    text = text.strip()
    if text.startswith(_Q):
        inner = text[len(_Q):]
        end = inner.find(_Q)
        return inner if end == -1 else inner[:end]
    if text.startswith("{"):
        return _parse_object(text[1:_scan(text, 1, "}")])
    if text.startswith("["):
        inner = text[1:_scan(text, 1, "]")]
        parts, i = [], 0
        while i <= len(inner):
            j = _scan(inner, i, ",")
            if inner[i:j].strip():
                parts.append(_parse_value(inner[i:j]))
            i = j + 1
            if j >= len(inner):
                break
        return parts
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text


def _parse_object(text: str) -> dict:
    out, i = {}, 0
    while i < len(text):
        j = _scan(text, i, ",")
        entry = text[i:j]
        i = j + 1
        colon = _scan(entry, 0, ":")
        if colon >= len(entry):
            continue
        key = entry[:colon].strip()
        if key:
            out[key] = _parse_value(entry[colon + 1:])
    return out


class Gemma4ToolParser:
    def parse(self, text: str, tools=None) -> Tuple[str, List[dict]]:
        calls = []
        for block in _BLOCK.findall(text):
            m = _CALL.search(block.strip())
            if not m:
                continue
            brace = m.end() - 1
            body = block[brace + 1:_scan(block, brace + 1, "}")]
            calls.append({"name": m.group(1),
                          "arguments": _parse_object(body)})
        return _BLOCK.sub("", text).strip(), calls
