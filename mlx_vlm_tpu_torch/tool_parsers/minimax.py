"""MiniMax XML invoke blocks (reference tool_parsers/minimax_m2.py and
minimax_m3.py — both use <invoke name=...><parameter name=...> bodies, M3
adds a namespace token around the tags).

Wire format (M2)::

    <minimax:tool_call>
    <invoke name="get_weather">
    <parameter name="city">Paris</parameter>
    </invoke>
    </minimax:tool_call>
"""

from __future__ import annotations

import re
from typing import List, Tuple

from ._common import coerce_by_schema, schema_properties

_SECTION = re.compile(
    r"(?:\]<\]minimax\[>\[)?<(?:minimax:)?tool_call>(.*?)"
    r"(?:\]<\]minimax\[>\[)?</(?:minimax:)?tool_call>", re.DOTALL)
_INVOKE = re.compile(
    r"<invoke\s+name=\"?([^\">\n]+)\"?>(.*?)</invoke>", re.DOTALL)
_PARAM = re.compile(
    r"<parameter\s+name=\"?([^\">\n]+)\"?>(.*?)</parameter>", re.DOTALL)
_NS = "]<]minimax[>["


class MinimaxToolParser:
    def parse(self, text: str, tools=None) -> Tuple[str, List[dict]]:
        calls = []
        for section in _SECTION.findall(text):
            body = section.replace(_NS, "")
            for name, inner in _INVOKE.findall(body):
                name = name.strip()
                props = schema_properties(name, tools)
                args = {}
                for pname, pval in _PARAM.findall(inner):
                    pname = pname.strip()
                    args[pname] = coerce_by_schema(pval.strip(), pname,
                                                   props)
                calls.append({"name": name, "arguments": args})
        return _SECTION.sub("", text).strip(), calls
