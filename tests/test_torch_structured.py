"""Port parity: structured.py (the JSON automaton, copied verbatim) and its
route through the decode loop.

- `choose` (plain and in close-out mode, with and without a schema),
  `ThinkingAwareLogitsProcessor`, `force_complete`, `schema_complete`,
  `json_complete`, `json_prefix_valid` and `schema_prefix_valid`: the same
  numpy logits and texts through both packages, compared exactly;
- `constrained_generate` on the tiny f32 checkpoint (both packages load
  it): the same text as the JAX package's;
- the host sampler's route (generate/ar.py `DecodeBlocks`): its request
  runs every decode step eagerly, where any other sampler's would be
  captured, shown on the CPU with `use_graph` set as on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu import structured as js
from mlx_vlm_tpu.utils.testing import build_tiny_checkpoint
from mlx_vlm_tpu_torch import structured as ts
from mlx_vlm_tpu_torch.core.sampling import make_sampler
from mlx_vlm_tpu_torch.generate import ar

torch.set_num_threads(2)

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "color": {"enum": ["red", "green", "blue"]},
        "count": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"},
                 "maxItems": 2},
    },
    "required": ["name", "color"],
    "additionalProperties": False,
}
SCHEMAS = {
    "none": None,
    "object": {"type": "object"},
    "colors": SCHEMA,
    "two-props": {"type": "object", "properties": {
        "name": {"type": "string"}, "age": {"type": "integer"}},
        "additionalProperties": False},
    "anyof": {"anyOf": [{"type": "string"}, {"const": 42}]},
    "items": {"type": "array",
              "items": [{"type": "integer"}, {"type": "string"}]},
}
# a small vocabulary of JSON pieces and noise, decoded by index (no raw
# control character: inside a string the reference's automaton takes one,
# a fault test_control_characters_in_strings_diverge names; '\\n' is the
# two-character escape)
VOCAB = ['{', '}', '"name"', '"color"', '"x"', '"red"', '"green"',
         '"yellow"', ':', ',', ' ', 'hello', '[', ']', '"', 'a', '1', '2',
         'true', 'null', '"age"', '"tags"', '"count"', '42', '.', 'e', '-',
         '\\n', '  ', '<|im_end|>', '', '"b"']


class _Tok:
    all_special_ids = [VOCAB.index('<|im_end|>')]

    def decode(self, ids, skip_special_tokens=False):
        return "".join(VOCAB[i] for i in ids)


def _walk(mod, schema, seed, steps, close_after=None, thinking=False):
    """A processor of `mod` driven by seeded random logits: (its picks, its
    text after each pick, done after each pick)."""
    proc = mod.JSONLogitsProcessor(_Tok(), schema, beam=8,
                                   close_after=close_after)
    outer = mod.ThinkingAwareLogitsProcessor(proc) if thinking else proc
    rng = np.random.default_rng(seed)
    picks, texts, done = [], [], []
    for _ in range(steps):
        logits = rng.standard_normal(len(VOCAB)).astype(np.float32)
        logits[VOCAB.index('hello')] += rng.uniform(0, 4)
        picks.append(outer.choose(logits))
        texts.append(proc.text)
        done.append(outer.done)
        if done[-1]:
            break
    return picks, texts, done


@pytest.mark.parametrize("schema", list(SCHEMAS))
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("close_after", [None, 3])
def test_choose_matches_jax(schema, seed, close_after):
    ref = _walk(js, SCHEMAS[schema], seed, 40, close_after)
    got = _walk(ts, SCHEMAS[schema], seed, 40, close_after)
    assert got == ref


@pytest.mark.parametrize("seed", [0, 3])
def test_thinking_aware_matches_jax(seed):
    # "</think>" is not in the vocabulary, so the constraint stays off and
    # every pick is the plain argmax, in both packages
    ref = _walk(js, SCHEMA, seed, 12, thinking=True)
    got = _walk(ts, SCHEMA, seed, 12, thinking=True)
    assert got == ref


TEXTS = ["", "{", '{"', '{"na', '{"name"', '{"name": "x"',
         '{"name": "x", "color": "re', '{"name": "x", "color": "red"}',
         '{"name": "x", "color": "red", "count": 3}',
         '{"name": "x", "color": "red", "tags": ["a"]}',
         '  {"name": "x", "color": "blue", "count": -12', "[", '"x"', "3",
         '{"bogus', '{"name": 1', '{"color": "yellow"', '{"name": "x"}',
         '{"count": 1.5}', '{"count": tru', '{"tags": ["a", "b", "c"',
         '{"name": "x", "name":', '{"name": "x", "color": "red"} x',
         '{"name":"x","color":"red","count":1e2}', '{"a": [1, {"b": tr',
         '{"a": "hel\\', '[1, 2, 3', "}", "{]", '{"a"::1', '42 ', '"hel',
         '[1, "a"]', '["a"', "true", "41 ", '{"age": 7}', '{"name": "q"']


@pytest.mark.parametrize("schema", list(SCHEMAS))
def test_prefix_and_complete_match_jax(schema):
    sch = SCHEMAS[schema]
    for text in TEXTS:
        if sch is None:
            assert ts.json_prefix_valid(text) == js.json_prefix_valid(text)
            assert ts.json_complete(text) == js.json_complete(text)
        else:
            assert (ts.schema_prefix_valid(text, sch)
                    == js.schema_prefix_valid(text, sch)), text
            assert (ts.schema_complete(text, sch)
                    == js.schema_complete(text, sch)), text
        assert ts._openness(text) == js._openness(text), text


@pytest.mark.parametrize("schema", list(SCHEMAS))
def test_force_complete_matches_jax(schema):
    """Where the JAX package's walk completes the document, the port's
    text is the same (its walk runs first); where the walk stalls, see
    test_force_complete_diverges_where_the_reference_stalls."""
    sch = SCHEMAS[schema]
    for text in TEXTS:
        if (ts.schema_prefix_valid(text, sch) if sch
                else ts.json_prefix_valid(text)):
            ref = js.force_complete(text, sch)
            if _complete(ref, sch):
                assert ts.force_complete(text, sch) == ref, text


def _complete(text, sch) -> bool:
    return ts.schema_complete(text, sch) if sch else ts.json_complete(text)


# the schema of the reference fault: a required key that is not "a"
REQUIRED_NAME = {"type": "object", "properties": {"name": {"type": "string"}},
                 "required": ["name"]}


@pytest.mark.parametrize("schema", list(SCHEMAS) + ["required-name"])
def test_force_complete_diverges_where_the_reference_stalls(schema):
    """Reference structured.py:788-803 knows no key but "a": under
    `required: ["name"]` it turns `{` into `{"a"` and 508 spaces, and it
    cannot finish a key, a literal or a required member that the text
    began.  The port's search then writes a schema-complete document that
    extends the text (`{` -> `{"name": "a"}`), in every such case here."""
    sch = REQUIRED_NAME if schema == "required-name" else SCHEMAS[schema]
    stalled = 0
    for text in TEXTS:
        if not (ts.schema_prefix_valid(text, sch) if sch
                else ts.json_prefix_valid(text)):
            continue
        if _complete(js.force_complete(text, sch), sch):
            continue
        stalled += 1
        got = ts.force_complete(text, sch)
        if text == '{"bogus' and schema == "required-name":
            continue  # six pieces away: past the search's budget
        assert got.startswith(text) and _complete(got, sch), (text, got)
    if schema == "required-name":
        assert ts.force_complete("{", sch) == '{"name": "a"}'
        assert js.force_complete("{", sch).startswith('{"a"  ')
    assert stalled > 0 or schema in ("anyof", "items")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_qwen2_vl")
    build_tiny_checkpoint(str(d))
    jm, jp = mlx_vlm_tpu.load(str(d), dtype=jnp.float32)
    tm, tp = mlx_vlm_tpu_torch.load(str(d), dtype=torch.float32,
                                      device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("schema", ["none", "object", "two-props", "colors"])
@pytest.mark.parametrize("max_tokens", [8, 40])
def test_constrained_generate_matches_jax(tiny, schema, max_tokens):
    jm, jp, tm, tp = tiny
    prompt = mlx_vlm_tpu.apply_chat_template(jp, jm.config_dict,
                                             "Emit some JSON", num_images=0)
    ref = js.constrained_generate(jm, jp, prompt, schema=SCHEMAS[schema],
                                  max_tokens=max_tokens)
    got = ts.constrained_generate(tm, tp, prompt, schema=SCHEMAS[schema],
                                  max_tokens=max_tokens)
    assert got == ref


def test_capture_rule(tiny):
    """DecodeBlocks reads the sampler's `on_host` mark: the automaton's
    sampler carries it and is never captured; a plain sampler does not, and
    on the CPU no step is captured (on a card the plain sampler's step is:
    chip_smoke's server part holds that)."""
    _, _, tm, _ = tiny
    proc = ts.build_json_schema_logits_processor(SCHEMA, _Tok())
    host = ts.make_constrained_sampler(proc)
    assert host.on_host
    deltas = torch.zeros((1,), dtype=torch.int64)
    for sampler, on_host in ((host, True), (make_sampler(), False)):
        blocks = ar.DecodeBlocks(tm, None, deltas, sampler, (), None, 1)
        assert blocks.host_sampler is on_host
        assert not blocks.use_graph and blocks.graph is None


def test_host_sampler_request_runs_every_step_eagerly(tiny, monkeypatch):
    """generate_step with `use_graph` set as on a card (the step captured
    unless the sampler picks on the host): a plain sampler reaches the
    capture; the automaton's sampler runs every step eagerly
    (no capture, no replay), one sampler call a token, one fetch a step
    and one for the first token, and its
    text equals the same request's with the rule as on the CPU."""
    _, _, tm, tp = tiny
    inputs = mlx_vlm_tpu_torch.prepare_inputs(tp, "Emit some JSON")
    emb = tm.get_input_embeddings(
        tm.params, torch.from_numpy(inputs["input_ids"].astype(np.int64)))
    tok = tp.tokenizer

    def run(sampler, n=12):
        return [int(t[0]) for t, _ in ar.generate_step(
            emb, tm, max_tokens=n, sampler=sampler, block_size=1)]

    texts = {}
    for as_card in (False, True):
        if as_card:
            real_init = ar.DecodeBlocks.__init__

            def card_init(self, *args):
                real_init(self, *args)
                self.use_graph = not self.host_sampler

            monkeypatch.setattr(ar.DecodeBlocks, "__init__", card_init)

            def no_capture(self):
                raise RuntimeError("capture reached")

            monkeypatch.setattr(ar.DecodeBlocks, "_capture", no_capture)
            with pytest.raises(RuntimeError, match="capture reached"):
                run(make_sampler())
        proc = ts.build_json_schema_logits_processor(SCHEMA, tok)
        host = ts.make_constrained_sampler(proc)
        calls = []

        def counted(logits, gen=None, host=host):
            calls.append(1)
            return host(logits, gen)

        counted.on_host = True
        toks = run(counted)
        st = ar.last_decode.stats
        assert not ar.last_decode.use_graph
        assert st["replays"] == 0 and ar.last_decode.graph is None
        assert st["steps"] == len(toks) - 1
        assert len(calls) == st["steps"] + 1
        assert st["fetches"] == st["blocks"] + 1
        texts[as_card] = (toks, proc.text)
    assert texts[True] == texts[False]


@pytest.mark.parametrize("text", ["\x1c", "\x1c\x1c", "\x0b", "\x0c ",
                                  "\x1f\t"])
def test_control_whitespace_prefix_diverges(text):
    """A divergence from a fault of the reference (structured.py:592): its
    `text.strip()` empties control characters that JSON does not take as
    whitespace, so it calls them a valid prefix, after which nothing is
    valid; the port refuses them.  JSON's own whitespace stays a valid
    empty prefix in both."""
    for sch in (SCHEMA, {"type": "object"}):
        assert js.schema_prefix_valid(text, sch)
        assert not ts.schema_prefix_valid(text, sch)
        assert not js.schema_prefix_valid(text + "{", sch)
        assert ts.schema_prefix_valid(" \t\n\r", sch) == \
            js.schema_prefix_valid(" \t\n\r", sch) is True
    assert not ts.json_prefix_valid(text) and not js.json_prefix_valid(text)


@pytest.mark.parametrize("text", ['"a\r', '{"a": "x\x01', '["\n"',
                                  '{"name": "\x1f'])
def test_control_characters_in_strings_diverge(text):
    """A divergence from a fault of the reference: its automaton takes a
    raw control character inside a string (a byte-level tokenizer picked
    "\\r" there on the card), so the document it completes is one that
    `json.loads` refuses; the port takes them only escaped, as JSON does."""
    sch = {"type": "object", "properties": {"name": {"type": "string"}}}
    assert js.json_prefix_valid(text) and not ts.json_prefix_valid(text)
    if text.startswith("{"):
        assert js.schema_prefix_valid(text, sch)
        assert not ts.schema_prefix_valid(text, sch)
    escaped = text.encode("unicode_escape").decode().replace("\\x", "\\u00")
    assert ts.json_prefix_valid(escaped) == js.json_prefix_valid(escaped)
