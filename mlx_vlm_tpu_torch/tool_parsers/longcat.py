"""LongCat tool calls (reference tool_parsers/longcat.py).

Wire format::

    <longcat_tool_call>get_weather
    <longcat_arg_key>city</longcat_arg_key>
    <longcat_arg_value>Paris</longcat_arg_value></longcat_tool_call>
"""

from __future__ import annotations

import re
from typing import List, Tuple

from ._common import coerce_by_schema, schema_properties

START, END = "<longcat_tool_call>", "</longcat_tool_call>"
_BLOCK = re.compile(re.escape(START) + r"(.*?)" + re.escape(END), re.DOTALL)
_NAME = re.compile(r"^(.*?)<longcat_arg_key>", re.DOTALL)
_PAIR = re.compile(
    r"<longcat_arg_key>(.*?)</longcat_arg_key>\s*"
    r"<longcat_arg_value>(.*?)</longcat_arg_value>", re.DOTALL)


class LongcatToolParser:
    def parse(self, text: str, tools=None) -> Tuple[str, List[dict]]:
        calls = []
        for block in _BLOCK.findall(text):
            m = _NAME.search(block)
            name = (m.group(1) if m else block).strip()
            props = schema_properties(name, tools)
            args = {}
            for key, val in _PAIR.findall(block):
                args[key.strip()] = coerce_by_schema(val.strip(),
                                                     key.strip(), props)
            if name:
                calls.append({"name": name, "arguments": args})
        return _BLOCK.sub("", text).strip(), calls
