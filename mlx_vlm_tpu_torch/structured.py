"""Constrained (structured-output) decoding.

Port of mlx_vlm_tpu/structured.py: the JSON automaton is copied verbatim
(json_prefix_valid :40, _SchemaWalker :299, schema_prefix_valid :585,
schema_complete :597, json_complete :606, JSONLogitsProcessor :647,
ThinkingAwareLogitsProcessor :765, force_complete :788,
build_json_schema_logits_processor :823).  The reference reads each
step's logits back through `jax.experimental.io_callback` inside its
jitted step (make_constrained_sampler :830); here the sampler copies the
step's logits to the host and returns the automaton's pick for each row
as a device tensor.  Such a sampler is marked `on_host`, and
generate/ar.py runs its request with every decode step eager: a captured
CUDA graph would freeze the one token its capture picked.

Two divergences, faults of the reference's automaton that a byte-level
tokenizer reaches: inside a string it takes no raw control character
(U+0000-U+001F; JSON takes them only escaped, and the reference's
automaton let "\r" into a document that `json.loads` then refused), and
`schema_prefix_valid` takes only JSON's whitespace for an empty prefix
(see there).

The reference's notes on the automaton: a pure-Python incremental
automaton (llguidance is not used): a JSON prefix pushdown for
schema-less json_object mode, plus a recursive-descent schema walker
(`_SchemaWalker`) that enforces type/properties/required/
additionalProperties/enum/const/items/minItems/maxItems/minLength/
maxLength/anyOf/oneOf while parsing — prefixes that no schema-satisfying
document extends are rejected mid-generation.  The host walks the
automaton over the top-`beam` candidates and returns the chosen token.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

__all__ = [
    "json_prefix_valid",
    "schema_prefix_valid",
    "schema_complete",
    "JSONLogitsProcessor",
    "ThinkingAwareLogitsProcessor",
    "build_json_schema_logits_processor",
    "constrained_generate",
]

_WS = " \t\n\r"


def json_prefix_valid(text: str) -> bool:
    """True iff `text` is a prefix of at least one valid JSON document.

    Character-level pushdown automaton over objects/arrays/strings/numbers/
    literals — no regex, no parser-error introspection.
    """
    stack: List[str] = []  # '{' or '['
    i, n = 0, len(text)
    # modes: expect_value, after_value, expect_key, after_key, in_string...
    mode = "value"
    string_ctx = None  # "key" or "value" while inside a string
    lit_word, lit_pos = "", 0  # exact-word literal tracking (true/false/null)

    def at_end(ok_modes):
        return True  # reaching end of input in any consistent state is fine

    while i < n:
        c = text[i]
        if mode == "string":
            if c == "\\":
                i += 2  # escape consumes next char (may run past end: fine)
                continue
            if c < " ":
                return False  # JSON strings take control characters escaped
            if c == '"':
                mode = "after_key" if string_ctx == "key" else "after_value"
            i += 1
            continue
        if mode == "number":
            if c in "0123456789+-.eE":
                i += 1
                continue
            mode = "after_value"
            continue  # re-examine c
        if mode == "literal":
            # exact-word match: "t"->"true" etc.; a bare prefix may end the
            # input, but any deviating character kills the document ("t "
            # or "tx" must NOT validate — v1 accepted any true/false/null
            # character soup, which let the constrained sampler stall)
            if lit_pos < len(lit_word):
                if c == lit_word[lit_pos]:
                    lit_pos += 1
                    i += 1
                    continue
                return False
            mode = "after_value"
            continue
        if c in _WS:
            i += 1
            continue

        if mode == "value":
            if c == "{":
                stack.append("{")
                mode = "key_or_close"
            elif c == "[":
                stack.append("[")
                mode = "value_or_close"
            elif c == '"':
                mode = "string"
                string_ctx = "value"
            elif c in "-0123456789":
                mode = "number"
            elif c in "tfn":
                mode = "literal"
                lit_word = {"t": "true", "f": "false", "n": "null"}[c]
                lit_pos = 1
            else:
                return False
            i += 1
        elif mode == "value_or_close":
            if c == "]":
                if not stack or stack.pop() != "[":
                    return False
                mode = "after_value"
                i += 1
            else:
                mode = "value"
        elif mode == "key_or_close":
            if c == "}":
                if not stack or stack.pop() != "{":
                    return False
                mode = "after_value"
                i += 1
            elif c == '"':
                mode = "string"
                string_ctx = "key"
                i += 1
            else:
                return False
        elif mode == "after_key":
            if c == ":":
                mode = "value"
                string_ctx = None
                i += 1
            else:
                return False
        elif mode == "after_value":
            if not stack:
                return False  # trailing garbage after a complete document
            top = stack[-1]
            if c == ",":
                mode = "key" if top == "{" else "value"
                i += 1
            elif c == "}" and top == "{":
                stack.pop()
                mode = "after_value"
                i += 1
            elif c == "]" and top == "[":
                stack.pop()
                mode = "after_value"
                i += 1
            else:
                return False
        elif mode == "key":
            if c == '"':
                mode = "string"
                string_ctx = "key"
                i += 1
            else:
                return False
        else:  # pragma: no cover
            return False
    return True


class _Incomplete(Exception):
    """Input ended mid-value but the prefix is still schema-consistent."""


class _Invalid(Exception):
    """No completion of this prefix can satisfy JSON + the schema."""


_NUM_COMPLETE = {"int", "frac", "exp", "zero"}


def _number_status(s: str) -> str:
    """JSON number grammar walk -> 'bad' | 'prefix' | 'complete'.

    Grammar: -?(0|[1-9][0-9]*)(\\.[0-9]+)?([eE][+-]?[0-9]+)?  — a 'prefix'
    needs more chars ('-', '1.', '2e+'); 'complete' may still extend.
    """
    st = "start"
    for c in s:
        if st == "start":
            if c == "-":
                st = "sign"
            elif c == "0":
                st = "zero"
            elif c in "123456789":
                st = "int"
            else:
                return "bad"
        elif st == "sign":
            if c == "0":
                st = "zero"
            elif c in "123456789":
                st = "int"
            else:
                return "bad"
        elif st in ("zero", "int"):
            if c == "." and True:
                st = "dot"
            elif c in "eE":
                st = "e"
            elif c.isdigit() and st == "int":
                pass
            else:
                return "bad"
        elif st == "dot":
            if c.isdigit():
                st = "frac"
            else:
                return "bad"
        elif st == "frac":
            if c.isdigit():
                pass
            elif c in "eE":
                st = "e"
            else:
                return "bad"
        elif st == "e":
            if c in "+-":
                st = "esign"
            elif c.isdigit():
                st = "exp"
            else:
                return "bad"
        elif st == "esign":
            if c.isdigit():
                st = "exp"
            else:
                return "bad"
        elif st == "exp":
            if not c.isdigit():
                return "bad"
    return "complete" if st in _NUM_COMPLETE else "prefix"


def _schema_types(schema) -> Optional[set]:
    """Allowed JSON type names, or None for unconstrained."""
    if not isinstance(schema, dict):
        return None
    t = schema.get("type")
    types = None
    if isinstance(t, str):
        types = {t}
    elif isinstance(t, list):
        types = set(t)
    vals = schema.get("enum")
    if vals is None and "const" in schema:
        vals = [schema["const"]]
    if vals is not None:
        etypes = set()
        for v in vals:
            if isinstance(v, bool):
                etypes.add("boolean")
            elif isinstance(v, str):
                etypes.add("string")
            elif isinstance(v, (int, float)):
                etypes.add("number")
            elif isinstance(v, dict):
                etypes.add("object")
            elif isinstance(v, list):
                etypes.add("array")
            elif v is None:
                etypes.add("null")
        types = etypes if types is None else types & etypes
    return types


def _type_ok(types: Optional[set], name: str) -> bool:
    if types is None:
        return True
    if name == "number":
        return bool({"number", "integer"} & types)
    return name in types


def _enum_values(schema):
    if not isinstance(schema, dict):
        return None
    if "enum" in schema:
        return schema["enum"]
    if "const" in schema:
        return [schema["const"]]
    return None


def _enum_prefix_ok(raw: str, values, kinds=(str,)) -> bool:
    """Partial raw value text vs candidate serializations of enum values."""
    for v in values:
        if isinstance(v, bool) or not isinstance(v, kinds):
            continue
        for dumped in (json.dumps(v), json.dumps(v, ensure_ascii=False)):
            if dumped.startswith(raw):
                return True
    return False


class _SchemaWalker:
    """Recursive-descent JSON parser that enforces a JSON-Schema subset
    while parsing: type, properties, required, additionalProperties, enum,
    const, items (schema or positional list), minItems/maxItems,
    minLength/maxLength, anyOf/oneOf.

    Raises _Invalid when no continuation can satisfy the schema, _Incomplete
    when input ends mid-value but remains consistent.  Mirrors what the
    reference gets from compiling the schema with llguidance
    (reference mlx_vlm/structured.py:262) as a pure-Python automaton.
    """

    def __init__(self, text: str):
        self.t = text
        self.i = 0
        self.n = len(text)

    # ---------------------------------------------------------- low-level
    def _ws(self):
        while self.i < self.n and self.t[self.i] in _WS:
            self.i += 1

    def _peek(self) -> str:
        self._ws()
        if self.i >= self.n:
            raise _Incomplete
        return self.t[self.i]

    def _expect(self, c: str):
        if self._peek() != c:
            raise _Invalid
        self.i += 1

    # ---------------------------------------------------------- values
    def parse_value(self, schema):
        branches = None
        if isinstance(schema, dict):
            branches = schema.get("anyOf") or schema.get("oneOf")
        if branches:
            start = self.i
            incomplete = False
            for br in branches:
                self.i = start
                try:
                    return self.parse_value(br)
                except _Incomplete:
                    incomplete = True
                except _Invalid:
                    continue
            if incomplete:
                raise _Incomplete
            raise _Invalid

        types = _schema_types(schema)
        enum = _enum_values(schema)
        c = self._peek()
        if c == "{":
            if not _type_ok(types, "object"):
                raise _Invalid
            v = self.parse_object(schema)
        elif c == "[":
            if not _type_ok(types, "array"):
                raise _Invalid
            v = self.parse_array(schema)
        elif c == '"':
            if not _type_ok(types, "string"):
                raise _Invalid
            v = self.parse_string(schema, enum)
        elif c in "-0123456789":
            if not _type_ok(types, "number"):
                raise _Invalid
            v = self.parse_number(types, enum)
        elif c in "tf":
            if not _type_ok(types, "boolean"):
                raise _Invalid
            v = self.parse_literal(("true", "false"))
        elif c == "n":
            if not _type_ok(types, "null"):
                raise _Invalid
            v = self.parse_literal(("null",))
        else:
            raise _Invalid
        if enum is not None and v not in enum:
            raise _Invalid
        return v

    def parse_literal(self, words):
        self._ws()
        rest = self.t[self.i :]
        for w in words:
            if rest.startswith(w):
                self.i += len(w)
                return {"true": True, "false": False, "null": None}[w]
        for w in words:
            if w.startswith(rest):
                raise _Incomplete
        raise _Invalid

    def parse_string(self, schema=None, enum=None):
        self._expect('"')
        start = self.i - 1
        out = []
        max_len = schema.get("maxLength") if isinstance(schema, dict) else None
        while True:
            if self.i >= self.n:
                raw = self.t[start :]
                if enum is not None and not _enum_prefix_ok(raw, enum):
                    raise _Invalid
                raise _Incomplete
            c = self.t[self.i]
            if c == "\\":
                if self.i + 1 >= self.n:
                    raise _Incomplete
                e = self.t[self.i + 1]
                if e == "u":
                    hexpart = self.t[self.i + 2 : self.i + 6]
                    if len(hexpart) < 4:
                        if all(h in "0123456789abcdefABCDEF" for h in hexpart):
                            raise _Incomplete
                        raise _Invalid
                    if not all(h in "0123456789abcdefABCDEF" for h in hexpart):
                        raise _Invalid
                    out.append(chr(int(hexpart, 16)))
                    self.i += 6
                elif e in '"\\/bfnrt':
                    out.append({"b": "\b", "f": "\f", "n": "\n", "r": "\r",
                                "t": "\t"}.get(e, e))
                    self.i += 2
                else:
                    raise _Invalid
            elif c == '"':
                self.i += 1
                s = "".join(out)
                if isinstance(schema, dict):
                    if len(s) < schema.get("minLength", 0):
                        raise _Invalid
                    if max_len is not None and len(s) > max_len:
                        raise _Invalid
                return s
            elif c < " ":
                raise _Invalid  # JSON strings take control characters escaped
            else:
                out.append(c)
                self.i += 1
            if max_len is not None and len(out) > max_len:
                raise _Invalid
            if enum is not None and self.i < self.n:
                # cheap pruning: raw-so-far must extend some enum dump
                raw = self.t[start : self.i]
                if self.t[self.i - 1] != '"' and not _enum_prefix_ok(
                        raw, enum):
                    raise _Invalid

    def parse_number(self, types, enum=None):
        self._ws()
        start = self.i
        while self.i < self.n and self.t[self.i] in "0123456789+-.eE":
            self.i += 1
        raw = self.t[start : self.i]
        status = _number_status(raw)
        if status == "bad":
            raise _Invalid
        if self.i >= self.n:
            if enum is not None and not _enum_prefix_ok(
                    raw, enum, kinds=(int, float)):
                raise _Invalid
            raise _Incomplete
        if status != "complete":
            raise _Invalid
        v = json.loads(raw)
        if types is not None and "integer" in types and "number" not in types:
            if not float(v).is_integer():
                raise _Invalid
        return v

    # ---------------------------------------------------------- containers
    def parse_object(self, schema):
        self._expect("{")
        props = {}
        required = ()
        addl = True
        if isinstance(schema, dict):
            props = schema.get("properties") or {}
            required = schema.get("required") or ()
            addl = schema.get("additionalProperties", True)
        seen = set()
        out = {}
        first = True
        while True:
            c = self._peek()
            if c == "}":
                # loop top is always start-of-object or after a completed
                # key:value pair, so '}' here is grammatically legal
                if not set(required) <= seen:
                    raise _Invalid
                self.i += 1
                return out
            if not first:
                self._expect(",")
                if addl is False and set(props) <= seen:
                    raise _Invalid  # no unseen key may follow this comma
            key = self._parse_key(props, addl, seen)
            self._expect(":")
            sub = props.get(key)
            if sub is None and isinstance(addl, dict):
                sub = addl
            out[key] = self.parse_value(sub)
            seen.add(key)
            first = False

    def _parse_key(self, props, addl, seen) -> str:
        self._ws()
        if self.i >= self.n:
            raise _Incomplete
        if self.t[self.i] != '"':
            raise _Invalid
        start = self.i
        # closed key set: partial keys must extend an allowed unseen key
        closed = addl is False
        try:
            key = self.parse_string()
        except _Incomplete:
            if closed:
                raw = self.t[start :]
                opts = [json.dumps(k) for k in props if k not in seen]
                if not any(o.startswith(raw) for o in opts):
                    raise _Invalid
            raise
        if closed and key not in props:
            raise _Invalid
        if key in seen:
            raise _Invalid  # duplicate keys never help satisfy the schema
        return key

    def parse_array(self, schema):
        self._expect("[")
        items = None
        min_items = 0
        max_items = None
        if isinstance(schema, dict):
            items = schema.get("items")
            if items is None:
                items = schema.get("prefixItems")
            min_items = schema.get("minItems", 0)
            max_items = schema.get("maxItems")
        out = []
        first = True
        while True:
            c = self._peek()
            if c == "]" and first:
                if len(out) < min_items:
                    raise _Invalid
                self.i += 1
                return out
            if not first:
                if c == "]":
                    if len(out) < min_items:
                        raise _Invalid
                    self.i += 1
                    return out
                self._expect(",")
            if max_items is not None and len(out) >= max_items:
                raise _Invalid
            if isinstance(items, list):
                sub = items[len(out)] if len(out) < len(items) else None
            else:
                sub = items
            out.append(self.parse_value(sub))
            first = False


def _schema_walk(text: str, schema) -> str:
    """-> 'complete' | 'prefix'; raises nothing (returns 'bad' on _Invalid)."""
    w = _SchemaWalker(text)
    try:
        w.parse_value(schema)
    except _Incomplete:
        return "prefix"
    except _Invalid:
        return "bad"
    except RecursionError:
        return "bad"
    w._ws()
    if w.i < w.n:
        return "bad"
    return "complete"


def schema_prefix_valid(text: str, schema) -> bool:
    """True iff `text` is a prefix of at least one JSON document satisfying
    `schema` (subset: type/properties/required/additionalProperties/enum/
    const/items/minItems/maxItems/minLength/maxLength/anyOf/oneOf).

    Reference compiles the schema grammar via llguidance
    (mlx_vlm/structured.py:262); this is the pure-Python equivalent.

    Only JSON's own whitespace counts as an empty prefix: the JAX
    package's `text.strip()` (structured.py:592) also strips the control
    characters that Python calls whitespace (\x0b, \x0c, \x1c-\x1f),
    which no JSON document may start with, so a byte-level tokenizer's
    automaton took them and then found nothing valid after them."""
    if not text.strip(_WS):
        return True
    return _schema_walk(text, schema) != "bad"


def schema_complete(text: str, schema) -> bool:
    """True iff `text` is a complete JSON document satisfying the schema."""
    if not text.strip():
        return False
    # a trailing space terminates a top-level number, which is otherwise
    # indistinguishable from a still-growing prefix
    return _schema_walk(text + " ", schema) == "complete"


def json_complete(text: str) -> bool:
    t = text.strip()
    if not t:
        return False
    try:
        json.loads(t)
        return True
    except json.JSONDecodeError:
        return False


def _openness(text: str) -> int:
    """How far `text` is from a complete JSON document: unclosed
    containers + 1 while inside a string/number/literal.  Drives the
    close-out preference when the token budget runs low."""
    depth = 0
    in_str = False
    esc = False
    tail_pending = False
    for c in text:
        if in_str:
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_str = False
            continue
        if c == '"':
            in_str = True
        elif c in "{[":
            depth += 1
        elif c in "}]":
            depth = max(0, depth - 1)
    t = text.rstrip()
    if t and not in_str and t[-1] not in "}]\"" and t[-1] not in _WS:
        # mid-number / mid-literal / after ':' or ',' — needs more chars
        tail_pending = t[-1] not in "el0123456789" or depth > 0
    return depth * 2 + (1 if in_str else 0) + (1 if tail_pending else 0)


class JSONLogitsProcessor:
    """Host-side constrained token chooser over the top-`beam` candidates.

    If no candidate keeps the output a valid JSON prefix, falls back to the
    unconstrained argmax (deadlock guard).  After `close_after` picks the
    chooser prefers candidates that REDUCE openness (close strings and
    containers) so bounded-token generations finish with a complete
    document instead of a truncated one.
    """

    def __init__(self, tokenizer, schema: Optional[dict] = None,
                 beam: int = 128, close_after: Optional[int] = None):
        self.tokenizer = tokenizer
        self.schema = schema
        self.beam = beam
        self.text = ""
        self._decode_cache = {}
        self._ws_run = 0  # consecutive pure-whitespace picks
        self.close_after = close_after
        self._picks = 0
        # special/added tokens must never enter the document: they decode
        # to marker text the detokenizer hides, desyncing the automaton
        # from the emitted stream
        specials = set(getattr(tokenizer, "all_special_ids", None) or ())
        added = getattr(tokenizer, "get_added_vocab", None)
        if callable(added):
            try:
                specials.update(added().values())
            except Exception:
                pass
        self.special_ids = specials

    def _tok_text(self, tid: int) -> str:
        s = self._decode_cache.get(tid)
        if s is None:
            s = self._decode_cache.setdefault(
                tid, self.tokenizer.decode([tid], skip_special_tokens=False)
            )
        return s

    def _ok(self, text: str) -> bool:
        if self.schema:
            # full schema-grammar walk (type/properties/required/enum/...)
            return schema_prefix_valid(text, self.schema)
        return json_prefix_valid(text)

    def choose(self, logits_row: np.ndarray) -> int:
        order = np.argsort(-logits_row)
        # whitespace is always "valid" JSON filler, so an unconditioned
        # model can emit it forever; after 2 consecutive all-WS picks only
        # structure-advancing tokens qualify
        ban_ws = self._ws_run >= 2

        def accept(tid):
            if int(tid) in self.special_ids:
                return False
            cand = self._tok_text(int(tid))
            if not cand:
                # empty-decoding tokens (bare specials, marker ids) are
                # vacuously "valid" and would stall the automaton forever
                return False
            if ban_ws and cand.strip() == "":
                return False
            new = self.text + cand
            if self._ok(new):
                self.text = new
                self._ws_run = self._ws_run + 1 if cand.strip() == "" else 0
                return True
            return False

        self._picks += 1
        closing = (self.close_after is not None
                   and self._picks > self.close_after)
        if closing:
            # close-out mode: among the valid beam candidates take the one
            # that most reduces openness (logit order breaks ties)
            base_text = self.text
            base_ws = self._ws_run
            best = None
            for tid in order[: self.beam]:
                if int(tid) in self.special_ids:
                    continue
                cand = self._tok_text(int(tid))
                if not cand or (base_ws >= 2 and cand.strip() == ""):
                    continue
                new = base_text + cand
                if self._ok(new):
                    op = _openness(new)
                    if best is None or op < best[0]:
                        best = (op, int(tid), new, cand)
                        if op == 0:
                            break
            if best is not None:
                _, tid, new, cand = best
                self.text = new
                self._ws_run = self._ws_run + 1 if cand.strip() == "" else 0
                return tid
        for tid in order[: self.beam]:
            if accept(tid):
                return int(tid)
        # exhaustive rescue: rare-but-required tokens (enum literals,
        # structural punctuation) can sit below the beam on a cold model —
        # scan the remaining vocab before conceding (correctness > speed;
        # this pass runs only when the beam found nothing)
        for tid in order[self.beam:]:
            if accept(tid):
                return int(tid)
        tid = int(order[0])  # deadlock guard: no token extends the prefix
        self.text += self._tok_text(tid)
        return tid

    @property
    def done(self) -> bool:
        if self.schema:
            return schema_complete(self.text, self.schema)
        return json_complete(self.text)


class ThinkingAwareLogitsProcessor:
    """Defers constraints until after `</think>` (reference structured.py:150)."""

    def __init__(self, inner: JSONLogitsProcessor, think_end: str = "</think>"):
        self.inner = inner
        self.think_end = think_end
        self._seen = ""
        self.active = False

    def choose(self, logits_row: np.ndarray) -> int:
        if self.active:
            return self.inner.choose(logits_row)
        tid = int(np.argmax(logits_row))
        self._seen += self.inner._tok_text(tid)
        if self.think_end in self._seen:
            self.active = True
        return tid

    @property
    def done(self) -> bool:
        return self.active and self.inner.done


# the reference's candidate pieces, roughly by closing power; multi-char
# pieces let key/value obligations resolve in one step
_FORCE_PIECES = ('"', "}", "]", "0", "null", "true", ":", ": 0", ", ",
                 '"a"', '"a": 0', "a", " ")


def _schema_pieces(schema) -> tuple:
    """(pieces, required keys): pieces that name what `schema` asks for,
    at any depth: each property
    as a key, each enum or const value, an empty value of each type, the
    openings of a document, and the rest of each key, value and literal
    after any of its characters (to finish one that the text began)."""
    keys, values, required = [], ['""', "false", "[]", "{}", "{", "["], []

    def visit(node):
        if isinstance(node, list):
            for x in node:
                visit(x)
            return
        if not isinstance(node, dict):
            return
        for k in node.get("required", ()) or ():
            keys.append(k)
            required.append(json.dumps(k))
        for k in (node.get("properties") or {}):
            keys.append(k)
        for v in node.get("enum", ()) or ():
            values.append(json.dumps(v))
        if "const" in node:
            values.append(json.dumps(node["const"]))
        for v in node.values():
            visit(v)

    visit(schema)
    out = []
    for k in keys:
        out += [json.dumps(k), json.dumps(k) + ": "]
    words = [json.dumps(k) for k in keys] + values + ["true", "null"]
    rests = [w[i:] for w in words for i in range(1, len(w))]
    return (tuple(dict.fromkeys(out + values + rests)),
            tuple(dict.fromkeys(required)))


def _greedy_complete(text: str, ok, done, max_steps: int) -> str:
    """The reference's walk: at each step append the piece that keeps the
    prefix valid and most reduces openness.  A second space in a row means
    the walk is stuck (what follows a space is what follows two), so the
    spaces that its remaining steps would append are appended at once."""
    for i in range(max_steps):
        if done(text):
            return text
        best = None
        for cand in _FORCE_PIECES:
            new = text + cand
            if ok(new):
                op = _openness(new)
                if best is None or op < best[0]:
                    best = (op, new)
                    if op == 0:
                        break
        if best is None:
            return text  # dead prefix; give up (caller already validated)
        if best[1] == text + " " and text.endswith(" "):
            return best[1] + " " * (max_steps - i - 1)
        text = best[1]
    return text


def _search_complete(text: str, ok, done, pieces: tuple, required: tuple,
                     budget: int) -> Optional[str]:
    """Best-first search over appended pieces (whitespace left out: it
    completes nothing) for a complete document, ranked by the pieces
    appended, the open containers and twice the `required` keys that the
    text does not name yet; None when `budget` prefixes were expanded
    without one."""
    import heapq

    def rank(t: str, steps: int) -> int:
        return steps + _openness(t) + 2 * sum(k not in t for k in required)

    pieces = tuple(c for c in pieces if c.strip())
    heap = [(rank(text, 0), 0, 0, text)]
    seen = {text}
    order = 1
    while heap and budget > 0:
        _, steps, _, t = heapq.heappop(heap)
        budget -= 1
        for cand in pieces:
            new = t + cand
            if new in seen or not ok(new):
                continue
            if done(new):
                return new
            seen.add(new)
            heapq.heappush(heap, (rank(new, steps + 1), steps + 1, order,
                                  new))
            order += 1
    return None


def force_complete(text: str, schema: Optional[dict] = None,
                   max_steps: int = 512) -> str:
    """Deterministically extend `text` to a complete schema-valid document
    (the llguidance "fast-forward/forced tokens" idea, reference
    structured.py -- here char-level).  Used when a length-bounded
    constrained generation ends mid-document.

    First the reference's greedy walk over its fixed pieces
    (`_greedy_complete`).  That walk knows no key but "a", so under a
    schema whose required keys are others it stalls (reference
    structured.py:788-803: `{` under `required: ["name"]` becomes `{"a"`
    and 508 spaces).  Where it ends incomplete, a best-first search over
    those pieces and the schema's own keys, enum / const values and empty
    values (`_search_complete`) finds a complete document, such as
    `{"name": ""}`; the walk's text is returned only when the search
    finds none either."""
    if schema:
        ok = lambda t: schema_prefix_valid(t, schema)
        done = lambda t: schema_complete(t, schema)
    else:
        ok = json_prefix_valid
        done = json_complete
    out = _greedy_complete(text, ok, done, max_steps)
    if done(out) or not ok(text):
        return out
    pieces, required = _schema_pieces(schema)
    found = _search_complete(text, ok, done, _FORCE_PIECES + pieces,
                             required, budget=max_steps)
    return out if found is None else found


def build_json_schema_logits_processor(schema, tokenizer, beam: int = 128):
    """Reference structured.py:262."""
    if isinstance(schema, str):
        schema = json.loads(schema)
    return JSONLogitsProcessor(tokenizer, schema, beam)


def make_constrained_sampler(proc: JSONLogitsProcessor):
    """Sampler for generate/ar.py: the step's logits [B, V] are copied to the
    host and the automaton picks each row's token (reference :830, there
    through an ordered io_callback).  Marked `on_host`, so that the decode
    loop runs every step of its request eagerly."""
    import torch

    def sampler(logits, generator=None):
        rows = logits.float().cpu().numpy()
        picks = [proc.choose(row) for row in rows]
        return torch.tensor(picks, dtype=torch.int64, device=logits.device)

    sampler.on_host = True
    return sampler


def constrained_generate(model, processor, prompt: str, schema=None,
                         max_tokens: int = 512, **kwargs) -> str:
    """Greedy JSON-constrained generation (block_size=1 host loop)."""
    from .generate.ar import generate_step
    from .generate.common import embed_prompt
    from .utils.processing import prepare_inputs

    tok = getattr(processor, "tokenizer", processor)
    proc = build_json_schema_logits_processor(schema, tok)
    sampler = make_constrained_sampler(proc)
    embeds, _, _ = embed_prompt(model, prepare_inputs(processor, prompt))
    for t, _ in generate_step(
        embeds, model, max_tokens=max_tokens, sampler=sampler, block_size=1,
        **kwargs,
    ):
        if proc.done:
            break
    return proc.text
