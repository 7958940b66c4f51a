"""Qwen3-Coder XML-ish tool calls (reference tool_parsers/qwen3_coder.py).

Wire format::

    <tool_call>
    <function=get_weather>
    <parameter=city>
    Paris
    </parameter>
    </function>
    </tool_call>

Argument values are raw text; the request's tool schema decides their type.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from ._common import coerce_by_schema, schema_properties

_BLOCK = re.compile(r"<tool_call>(.*?)</tool_call>", re.DOTALL)
_FUNC = re.compile(r"<function=([^>\n]+)>(.*?)</function>", re.DOTALL)
_PARAM = re.compile(r"<parameter=([^>\n]+)>(.*?)</parameter>", re.DOTALL)


class Qwen3CoderToolParser:
    def parse(self, text: str, tools=None) -> Tuple[str, List[dict]]:
        calls = []
        for block in _BLOCK.findall(text):
            for name, body in _FUNC.findall(block):
                name = name.strip()
                props = schema_properties(name, tools)
                args = {}
                for pname, pval in _PARAM.findall(body):
                    pname = pname.strip()
                    args[pname] = coerce_by_schema(pval.strip("\n"), pname,
                                                   props)
                calls.append({"name": name, "arguments": args})
        return _BLOCK.sub("", text).strip(), calls
