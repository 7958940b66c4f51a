"""Port parity: tool_parsers/ (copied verbatim from the JAX package).

The cases of tests/test_tool_parsers.py, and a few more, through both
packages' parsers: the clean text and the parsed calls must be equal, and
the registry must pick the same parser class by name or by template
marker."""

import importlib

import pytest

import mlx_vlm_tpu.tool_parsers as jtp
import mlx_vlm_tpu_torch.tool_parsers as ttp

TOOLS = [{"type": "function", "function": {
    "name": "get_weather",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string"},
        "days": {"type": "integer"},
        "units": {"type": "string"},
    }}}}]

# (module, class, text, takes tools)
CASES = [
    ("hermes", "HermesToolParser",
     'Sure.\n<tool_call>\n{"name": "get_weather", "arguments": {"city": '
     '"Paris"}}\n</tool_call>', False),
    ("hermes", "HermesToolParser",
     '<tool_call>{"name": "a", "arguments": {}}</tool_call>'
     '<tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>', False),
    ("hermes", "HermesToolParser", "just text", False),
    ("hermes", "HermesToolParser",
     'a <tool_call>{"name": "f", "arguments": {broken</tool_call> b', False),
    ("mistral", "MistralToolParser",
     '[TOOL_CALLS] [{"name": "f", "arguments": {"a": 2}}]', False),
    ("mistral", "MistralToolParser", "no calls here", False),
    ("pythonic", "PythonicToolParser", '[get_time(tz="UTC")]', False),
    ("pythonic", "PythonicToolParser", "hello world", False),
    ("pythonic", "PythonicToolParser", '[f(a=1, b=[1, 2]), g()]', False),
    ("json_tools", "JsonToolParser", '{"name": "go", "arguments": {}}',
     False),
    ("json_tools", "JsonToolParser",
     'text [{"name": "a", "arguments": {"k": "v"}}] more', False),
    ("kimi_k2", "KimiK2ToolParser",
     "ok<|tool_calls_section_begin|><|tool_call_begin|>"
     "functions.get_weather:0<|tool_call_argument_begin|>"
     '{"city": "Paris"}<|tool_call_end|><|tool_calls_section_end|>', True),
    ("kimi_k2", "KimiK2ToolParser",
     "<|tool_call_begin|>a:0<|tool_call_argument_begin|>{}"
     "<|tool_call_end|><|tool_call_begin|>b:1"
     '<|tool_call_argument_begin|>{"x": 1}<|tool_call_end|>', True),
    ("longcat", "LongcatToolParser",
     "<longcat_tool_call>get_weather<longcat_arg_key>city</longcat_arg_key>"
     "<longcat_arg_value>Paris</longcat_arg_value>"
     "<longcat_arg_key>days</longcat_arg_key>"
     "<longcat_arg_value>3</longcat_arg_value></longcat_tool_call>", True),
    ("cohere2", "Cohere2ToolParser",
     '<|START_ACTION|>[{"tool_name": "get_weather", "parameters": {"city": '
     '"Nice"}}]<|END_ACTION|>', True),
    ("cohere2", "Cohere2ToolParser",
     '<|START_ACTION|>{"tool_name": "grep", "parameters": {"re": "a\\|b"}}'
     "<|END_ACTION|>", True),
    ("function_gemma", "FunctionGemmaToolParser",
     "<start_function_call>call:get_weather{city:<escape>New York<escape>,"
     "days:2}<end_function_call>", True),
    ("qwen3_coder", "Qwen3CoderToolParser",
     "<tool_call>\n<function=get_weather>\n<parameter=city>\nParis\n"
     "</parameter>\n<parameter=days>\n5\n</parameter>\n</function>\n"
     "</tool_call>", True),
    ("glm4", "Glm4ToolParser",
     "<tool_call>get_weather\n<arg_key>city</arg_key><arg_value>Oslo"
     "</arg_value>\n<arg_key>days</arg_key><arg_value>7</arg_value>"
     "</tool_call>", True),
    ("minimax", "MinimaxToolParser",
     '<minimax:tool_call>\n<invoke name="get_weather">\n<parameter '
     'name="city">Rome</parameter>\n<parameter name="days">2</parameter>\n'
     "</invoke>\n</minimax:tool_call>", True),
    ("minimax", "MinimaxToolParser",
     ']<]minimax[>[<tool_call>]<]minimax[>[<invoke name="f">]<]minimax[>['
     "</invoke>]<]minimax[>[</tool_call>", True),
    ("gemma4", "Gemma4ToolParser",
     '<|tool_call>call:get_weather{city:<|"|>San, Francisco<|"|>,days:3,'
     'opts:{units:<|"|>metric<|"|>}}<tool_call|>', True),
]


def _parser(pkg, module: str, cls: str):
    return getattr(importlib.import_module(f"{pkg.__name__}.{module}"), cls)()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_parse_matches_jax(case):
    module, cls, text, with_tools = CASES[case]
    kw = {"tools": TOOLS} if with_tools else {}
    ref = _parser(jtp, module, cls).parse(text, **kw)
    got = _parser(ttp, module, cls).parse(text, **kw)
    assert got == ref
    assert type(got[0]) is type(ref[0]) and type(got[1]) is type(ref[1])


@pytest.mark.parametrize("name_or_template", [
    None, "", "hermes", "qwen", "mistral", "pythonic", "json", "kimi_k2",
    "longcat", "cohere2", "cohere2_moe", "function_gemma", "gemma4", "glm4",
    "glm47", "minimax", "minimax_m2", "minimax_m3", "qwen3_coder",
    "uses <tool_call> marker", "has [TOOL_CALLS] inside",
    "x <|tool_calls_section_begin|>", "x <|START_ACTION|>",
    "x <|tool_call> y", "<tool_call> with <arg_key>",
    "<tool_call><function=f>", "uses minimax:tool_call",
    "]<]minimax[>[", "<|python_tag|>", "<longcat_tool_call>",
    "<start_function_call>", "no marker at all"])
def test_registry_matches_jax(name_or_template):
    assert (type(ttp.get_tool_parser(name_or_template)).__name__
            == type(jtp.get_tool_parser(name_or_template)).__name__)


@pytest.mark.parametrize("text", [
    '{"name": "go", "arguments": {}}', "plain", '[{"name": "x"}]'])
def test_parse_tool_calls_default_matches_jax(text):
    assert ttp.parse_tool_calls(text) == jtp.parse_tool_calls(text)
