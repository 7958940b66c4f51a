"""Cohere Command action blocks (reference tool_parsers/cohere2_moe.py).

Wire format::

    <|START_ACTION|>[{"tool_name": "get_weather",
                      "parameters": {"city": "Paris"}}]<|END_ACTION|>
"""

from __future__ import annotations

import json
import re
from typing import List, Tuple

START, END = "<|START_ACTION|>", "<|END_ACTION|>"
_BLOCK = re.compile(re.escape(START) + r"(.*?)" + re.escape(END), re.DOTALL)


class Cohere2ToolParser:
    def parse(self, text: str, tools=None) -> Tuple[str, List[dict]]:
        calls = []
        for block in _BLOCK.findall(text):
            # Command sometimes emits invalid JSON escapes like "\|"
            payload = block.strip().replace("\\|", "|")
            try:
                action = json.loads(payload)
            except json.JSONDecodeError:
                continue
            items = action if isinstance(action, list) else [action]
            for call in items:
                name = call.get("tool_name") or call.get("name")
                if name:
                    calls.append({"name": name,
                                  "arguments": call.get("parameters", {})})
        return _BLOCK.sub("", text).strip(), calls
