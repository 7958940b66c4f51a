"""Kimi-K2 tool calls (reference tool_parsers/kimi_k2.py).

Wire format::

    <|tool_calls_section_begin|>
    <|tool_call_begin|>functions.get_weather:0<|tool_call_argument_begin|>
    {"city": "Paris"}<|tool_call_end|>
    <|tool_calls_section_end|>
"""

from __future__ import annotations

import re
from typing import List, Tuple

from ._common import loose_loads

SECTION_START = "<|tool_calls_section_begin|>"
SECTION_END = "<|tool_calls_section_end|>"
_CALL = re.compile(r"<\|tool_call_begin\|>(.*?)<\|tool_call_end\|>",
                   re.DOTALL)
_HEAD = re.compile(
    r"^\s*(?:functions\.)?(.+?):\d+\s*<\|tool_call_argument_begin\|>\s*"
    r"(.*)\s*$", re.DOTALL)


class KimiK2ToolParser:
    def parse(self, text: str, tools=None) -> Tuple[str, List[dict]]:
        calls = []
        for block in _CALL.findall(text):
            m = _HEAD.match(block)
            if not m:
                continue
            calls.append({"name": m.group(1),
                          "arguments": loose_loads(m.group(2))})
        clean = _CALL.sub("", text)
        clean = clean.replace(SECTION_START, "").replace(SECTION_END, "")
        return clean.strip(), calls
