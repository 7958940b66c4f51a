"""Bare-JSON tool-call parser: the whole output (or a fenced block) is a
{"name": ..., "arguments": ...} object or list."""

from __future__ import annotations

import json
import re
from typing import List, Tuple

_FENCE = re.compile(r"```(?:json)?\s*(.*?)```", re.DOTALL)


class JsonToolParser:
    def parse(self, text: str) -> Tuple[str, List[dict]]:
        candidates = [m.group(1) for m in _FENCE.finditer(text)] or [text.strip()]
        for cand in candidates:
            try:
                obj = json.loads(cand)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict):
                obj = [obj]
            if isinstance(obj, list) and all(
                isinstance(o, dict) and "name" in o for o in obj
            ):
                return "", [
                    {"name": o["name"], "arguments": o.get("arguments", o.get("parameters", {}))}
                    for o in obj
                ]
        return text, []
