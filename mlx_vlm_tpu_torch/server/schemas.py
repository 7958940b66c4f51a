"""Request schemas: lenient models with a small validator of their own.

Port of mlx_vlm_tpu/server/schemas.py (FlexibleBaseModel :14, OpenAIMessage
:18, OpenAIChatRequest :23, AnthropicContentBlock :40, AnthropicMessage :46,
AnthropicMessagesRequest :51).  The reference declares them as pydantic
models; the port does not import pydantic, so `FlexibleBaseModel` checks
the fields declared by each class's annotations itself, as pydantic's lax
mode does for JSON bodies: required fields, the declared types (Optional,
Union, List, Dict, Any, nested models; numbers and booleans coerced from
their string and numeric forms), the class defaults, unknown keys kept as
attributes (`extra="allow"`) and `model_dump()`.  A bad body raises
`ValidationError`, a ValueError, which the server answers with 400
`invalid_request_error` (server/app.py).
"""

from __future__ import annotations

import math
import re
import typing
from typing import Any, Dict, List, Optional, Union

_MISSING = object()
_INT_STR = re.compile(r"[+-]?[0-9]+(_[0-9]+)*(\.0*)?")
_BOOL_STR = {"0": False, "off": False, "f": False, "false": False,
             "n": False, "no": False, "1": True, "on": True, "t": True,
             "true": True, "y": True, "yes": True}


class ValidationError(ValueError):
    """A request body that does not fit its schema; lists every field that
    failed."""

    def __init__(self, model: str, errors: List[tuple]):
        self.errors = errors
        lines = [f"{len(errors)} validation error"
                 f"{'s' if len(errors) > 1 else ''} for {model}"]
        for loc, msg in errors:
            lines += [".".join(map(str, loc)) or "(body)", f"  {msg}"]
        super().__init__("\n".join(lines))


class _Invalid(Exception):
    def __init__(self, errors: List[tuple]):
        self.errors = errors


def _to_int(v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float) and math.isfinite(v) and v.is_integer() \
            and abs(v) < 2**63:
        return int(v)
    if isinstance(v, str) and _INT_STR.fullmatch(v.strip()):
        return int(v.strip().split(".")[0])
    raise _Invalid([((), "Input should be a valid integer")])


def _to_float(v):
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, str) and v.strip().isascii():
        try:
            return float(v.strip())
        except ValueError:
            pass
    raise _Invalid([((), "Input should be a valid number")])


def _to_bool(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _BOOL_STR:
        return _BOOL_STR[v.lower()]
    raise _Invalid([((), "Input should be a valid boolean")])


def _to_str(v):
    if isinstance(v, str):
        return v
    raise _Invalid([((), "Input should be a valid string")])


_SCALARS = {int: _to_int, float: _to_float, bool: _to_bool, str: _to_str}


def _strict(tp, v) -> bool:
    """Whether `v` already is of type `tp` without coercion (a Union tries
    its members so first, as pydantic's smart mode does)."""
    if tp is Any:
        return True
    if tp is type(None):
        return v is None
    if tp in _SCALARS:
        return type(v) is tp
    return False


def _coerce(tp, v):
    """`v` validated against the annotation `tp`; raises _Invalid with the
    location of each failure inside `v`."""
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if tp is Any:
        return v
    if tp is type(None):
        if v is None:
            return None
        raise _Invalid([((), "Input should be None")])
    if origin is Union:
        for member in args:
            if _strict(member, v):
                return v
        errors = []
        for member in args:
            try:
                return _coerce(member, v)
            except _Invalid as e:
                errors += e.errors
        raise _Invalid(errors)
    if origin in (list, List):
        if not isinstance(v, (list, tuple)):
            raise _Invalid([((), "Input should be a valid list")])
        out, errors = [], []
        for i, item in enumerate(v):
            try:
                out.append(_coerce(args[0] if args else Any, item))
            except _Invalid as e:
                errors += [((i,) + loc, msg) for loc, msg in e.errors]
        if errors:
            raise _Invalid(errors)
        return out
    if origin in (dict, Dict):
        if not isinstance(v, dict):
            raise _Invalid([((), "Input should be a valid dictionary")])
        key_t, val_t = args if args else (Any, Any)
        out, errors = {}, []
        for k, item in v.items():
            try:
                out[_coerce(key_t, k)] = _coerce(val_t, item)
            except _Invalid as e:
                errors += [((k,) + loc, msg) for loc, msg in e.errors]
        if errors:
            raise _Invalid(errors)
        return out
    if isinstance(tp, type) and issubclass(tp, FlexibleBaseModel):
        if isinstance(v, tp):
            return v
        if not isinstance(v, dict):
            raise _Invalid([((), f"Input should be a valid dictionary or "
                                 f"instance of {tp.__name__}")])
        return tp._validated(v)
    if tp in _SCALARS:
        return _SCALARS[tp](v)
    raise TypeError(f"unsupported field type {tp!r}")


class FlexibleBaseModel:
    """A model whose fields are its class annotations and whose defaults
    are its class attributes; unknown keys are kept (reference
    FlexibleBaseModel, pydantic `extra="allow"`)."""

    _fields: Dict[str, tuple] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        hints = typing.get_type_hints(cls)
        cls._fields = {
            name: (tp, getattr(cls, name, _MISSING))
            for name, tp in hints.items() if not name.startswith("_")}

    def __init__(self, **data):
        try:
            self._fill(data)
        except _Invalid as e:
            raise ValidationError(type(self).__name__, e.errors) from None

    @classmethod
    def _validated(cls, data: dict):
        obj = cls.__new__(cls)
        obj._fill(data)
        return obj

    def _fill(self, data: dict) -> None:
        values, errors = {}, []
        for name, (tp, default) in self._fields.items():
            if name not in data:
                if default is _MISSING:
                    errors.append(((name,), "Field required"))
                else:
                    values[name] = default
                continue
            try:
                values[name] = _coerce(tp, data[name])
            except _Invalid as e:
                errors += [((name,) + loc, msg) for loc, msg in e.errors]
        if errors:
            raise _Invalid(errors)
        self.__dict__.update(values)
        self._extra = {k: v for k, v in data.items() if k not in self._fields}

    def __getattr__(self, name):
        extra = self.__dict__.get("_extra", {})
        if name in extra:
            return extra[name]
        raise AttributeError(f"{type(self).__name__!r} object has no "
                             f"attribute {name!r}")

    def model_dump(self) -> dict:
        """The declared fields, then the unknown keys, nested models
        dumped too."""
        out = {k: _dump(getattr(self, k)) for k in self._fields}
        out.update(self._extra)
        return out


def _dump(v):
    if isinstance(v, FlexibleBaseModel):
        return v.model_dump()
    if isinstance(v, list):
        return [_dump(x) for x in v]
    if isinstance(v, dict):
        return {k: _dump(x) for k, x in v.items()}
    return v


class OpenAIMessage(FlexibleBaseModel):
    role: str
    content: Union[str, List[Dict[str, Any]], None] = None


class OpenAIChatRequest(FlexibleBaseModel):
    model: Optional[str] = None
    messages: List[OpenAIMessage]
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    temperature: float = 0.0
    top_p: float = 1.0
    stream: bool = False
    stop: Optional[Union[str, List[str]]] = None
    seed: Optional[int] = None
    logprobs: Optional[bool] = None
    # {"type": "json_object"} or {"type": "json_schema",
    #  "json_schema": {"schema": {...}}} (OpenAI structured outputs)
    response_format: Optional[Dict[str, Any]] = None


class AnthropicContentBlock(FlexibleBaseModel):
    type: str
    text: Optional[str] = None
    source: Optional[Dict[str, Any]] = None


class AnthropicMessage(FlexibleBaseModel):
    role: str
    content: Union[str, List[AnthropicContentBlock]]


class AnthropicMessagesRequest(FlexibleBaseModel):
    model: Optional[str] = None
    messages: List[AnthropicMessage]
    system: Optional[Union[str, List[Dict[str, Any]]]] = None
    max_tokens: int = 512
    temperature: float = 0.0
    top_p: float = 1.0
    stream: bool = False
    stop_sequences: Optional[List[str]] = None
