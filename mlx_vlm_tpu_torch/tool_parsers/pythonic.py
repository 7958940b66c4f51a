"""Pythonic `fn(a=1, b="x")` call-expression parser (llama-style)."""

from __future__ import annotations

import ast
from typing import List, Tuple


class PythonicToolParser:
    def parse(self, text: str) -> Tuple[str, List[dict]]:
        t = text.strip()
        if t.startswith("<|python_tag|>"):
            t = t[len("<|python_tag|>"):]
        t = t.strip()
        if t.startswith("[") and t.endswith("]"):
            inner = t
        elif "(" in t and t.endswith(")"):
            inner = f"[{t}]"
        else:
            return text, []
        try:
            tree = ast.parse(inner, mode="eval")
            calls = []
            if not isinstance(tree.body, ast.List):
                return text, []
            for node in tree.body.elts:
                if not isinstance(node, ast.Call):
                    continue
                name = getattr(node.func, "id", None) or getattr(
                    node.func, "attr", None
                )
                args = {
                    kw.arg: ast.literal_eval(kw.value) for kw in node.keywords
                }
                calls.append({"name": name, "arguments": args})
            return ("" if calls else text), calls
        except (SyntaxError, ValueError):
            return text, []
