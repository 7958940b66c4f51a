"""FunctionGemma calls (reference tool_parsers/function_gemma.py).

Wire format::

    <start_function_call>call:get_weather{city:<escape>Paris<escape>,n:2}
    <end_function_call>

String values are <escape>-delimited; everything else parses as JSON.
"""

from __future__ import annotations

import json
import re
from typing import List, Tuple

START, END = "<start_function_call>", "<end_function_call>"
_BLOCK = re.compile(re.escape(START) + r"(.*?)" + re.escape(END), re.DOTALL)
_CALL = re.compile(r"call:([\w.:-]+)\{(.*)\}", re.DOTALL)
_ESCAPE = "<escape>"


def _parse_args(body: str) -> dict:
    args = {}
    rest = body
    while rest:
        if ":" not in rest:
            break
        key, rest = rest.split(":", 1)
        key = key.strip()
        if rest.startswith(_ESCAPE):
            rest = rest[len(_ESCAPE):]
            end = rest.find(_ESCAPE)
            if end == -1:
                args[key] = rest
                break
            args[key] = rest[:end]
            rest = rest[end + len(_ESCAPE):].lstrip(",")
            continue
        cut = rest.find(",") if "," in rest else len(rest)
        raw = rest[:cut]
        rest = rest[cut + 1:]
        try:
            args[key] = json.loads(raw)
        except json.JSONDecodeError:
            args[key] = raw
    return args


class FunctionGemmaToolParser:
    def parse(self, text: str, tools=None) -> Tuple[str, List[dict]]:
        calls = []
        for block in _BLOCK.findall(text):
            m = _CALL.search(block)
            if not m:
                continue
            calls.append({"name": m.group(1),
                          "arguments": _parse_args(m.group(2))})
        return _BLOCK.sub("", text).strip(), calls
