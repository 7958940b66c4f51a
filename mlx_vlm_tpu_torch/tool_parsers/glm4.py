"""GLM-4.x arg_key/arg_value tool calls (reference tool_parsers/glm47.py).

Wire format::

    <tool_call>get_weather
    <arg_key>city</arg_key>
    <arg_value>Paris</arg_value>
    </tool_call>
"""

from __future__ import annotations

import re
from typing import List, Tuple

from ._common import coerce_by_schema, schema_properties

_BLOCK = re.compile(r"<tool_call>(.*?)</tool_call>", re.DOTALL)
_NAME = re.compile(r"^(.*?)<arg_key>", re.DOTALL)
_PAIR = re.compile(r"<arg_key>(.*?)</arg_key>\s*<arg_value>(.*?)</arg_value>",
                   re.DOTALL)


class Glm4ToolParser:
    def parse(self, text: str, tools=None) -> Tuple[str, List[dict]]:
        calls = []
        for block in _BLOCK.findall(text):
            m = _NAME.search(block)
            name = (m.group(1) if m else block).strip()
            if not name:
                continue
            props = schema_properties(name, tools)
            args = {}
            for key, val in _PAIR.findall(block):
                key = key.strip()
                # schema says string -> keep verbatim; else deserialize
                args[key] = (val.strip()
                             if props.get(key, {}).get("type") == "string"
                             else coerce_by_schema(val.strip(), key, props))
            calls.append({"name": name, "arguments": args})
        return _BLOCK.sub("", text).strip(), calls
