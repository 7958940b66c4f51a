"""Mistral `[TOOL_CALLS] [{...}, ...]` parser."""

from __future__ import annotations

import json
from typing import List, Tuple

MARKER = "[TOOL_CALLS]"


class MistralToolParser:
    def parse(self, text: str) -> Tuple[str, List[dict]]:
        if MARKER not in text:
            return text, []
        before, _, after = text.partition(MARKER)
        after = after.strip()
        calls = []
        try:
            arr = json.loads(after)
            if isinstance(arr, dict):
                arr = [arr]
            for obj in arr:
                calls.append({
                    "name": obj.get("name"),
                    "arguments": obj.get("arguments", {}),
                })
        except json.JSONDecodeError:
            pass
        return before.strip(), calls
