"""Shared helpers for wire-format tool-call parsers."""

from __future__ import annotations

import ast
import json
from typing import Any, Iterable, Optional


def loose_loads(value: str) -> Any:
    """JSON first, python literal second, raw string last (the reference
    parsers' _deserialize convention)."""
    for loader in (json.loads, ast.literal_eval):
        try:
            return loader(value)
        except Exception:  # noqa: BLE001
            continue
    return value


def schema_properties(tool_name: str, tools: Optional[Iterable]) -> dict:
    """The JSON-schema `properties` dict for a named function, if the
    request supplied tool definitions."""
    for tool in tools or ():
        func = tool.get("function") if isinstance(tool, dict) else None
        if func and func.get("name") == tool_name:
            return (func.get("parameters") or {}).get("properties") or {}
    return {}


def coerce_by_schema(value: str, name: str, props: dict) -> Any:
    """Convert a raw string argument using its schema-declared type."""
    spec = props.get(name)
    if not spec:
        return loose_loads(value)
    t = str(spec.get("type", "string")).lower()
    if value.lower() == "null":
        return None
    if t in ("string", "str", "text", "enum"):
        return value
    if t in ("boolean", "bool"):
        return value.strip().lower() == "true"
    if t.startswith(("int", "uint", "long", "short")):
        return int(value)
    if t.startswith(("num", "float")):
        f = float(value)
        return int(f) if f == int(f) else f
    return loose_loads(value)
