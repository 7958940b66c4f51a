"""Hermes/Qwen-style `<tool_call>{json}</tool_call>` parser."""

from __future__ import annotations

import json
import re
from typing import List, Tuple

_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)


class HermesToolParser:
    def parse(self, text: str) -> Tuple[str, List[dict]]:
        calls = []
        for m in _RE.finditer(text):
            try:
                obj = json.loads(m.group(1))
                calls.append({
                    "name": obj.get("name"),
                    "arguments": obj.get("arguments", {}),
                })
            except json.JSONDecodeError:
                continue
        clean = _RE.sub("", text).strip()
        return clean, calls
