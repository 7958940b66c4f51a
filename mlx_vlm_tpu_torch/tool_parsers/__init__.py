"""Tool-call parsing registry.

Port of mlx_vlm_tpu/tool_parsers/ (get_tool_parser :62), the whole
package copied verbatim: pure Python, no device work.
Role parity: reference mlx_vlm/tool_parsers/ — chat-template marker
sniffing selects a per-family parser module (tool_parsers/__init__.py:11-25;
families incl. qwen/hermes, mistral, pythonic, json_tools).
"""

from __future__ import annotations

from typing import List, Optional

from .cohere2 import Cohere2ToolParser
from .function_gemma import FunctionGemmaToolParser
from .gemma4 import Gemma4ToolParser
from .glm4 import Glm4ToolParser
from .hermes import HermesToolParser
from .json_tools import JsonToolParser
from .kimi_k2 import KimiK2ToolParser
from .longcat import LongcatToolParser
from .minimax import MinimaxToolParser
from .mistral import MistralToolParser
from .pythonic import PythonicToolParser
from .qwen3_coder import Qwen3CoderToolParser

_PARSERS = {
    "hermes": HermesToolParser,
    "qwen": HermesToolParser,
    "mistral": MistralToolParser,
    "pythonic": PythonicToolParser,
    "json": JsonToolParser,
    "kimi_k2": KimiK2ToolParser,
    "longcat": LongcatToolParser,
    "cohere2": Cohere2ToolParser,
    "cohere2_moe": Cohere2ToolParser,
    "function_gemma": FunctionGemmaToolParser,
    "gemma4": Gemma4ToolParser,
    "glm4": Glm4ToolParser,
    "glm47": Glm4ToolParser,
    "minimax": MinimaxToolParser,
    "minimax_m2": MinimaxToolParser,
    "minimax_m3": MinimaxToolParser,
    "qwen3_coder": Qwen3CoderToolParser,
}

# markers in a chat template that identify the family (order matters:
# more specific markers first — several families nest inside <tool_call>)
_TEMPLATE_MARKERS = [
    ("<|tool_calls_section_begin|>", "kimi_k2"),
    ("<longcat_tool_call>", "longcat"),
    ("<|START_ACTION|>", "cohere2"),
    ("<start_function_call>", "function_gemma"),
    ("<|tool_call>", "gemma4"),
    ("minimax:tool_call", "minimax"),
    ("]<]minimax[>[", "minimax"),
    ("<arg_key>", "glm4"),
    ("<function=", "qwen3_coder"),
    ("<tool_call>", "hermes"),
    ("[TOOL_CALLS]", "mistral"),
    ("<|python_tag|>", "pythonic"),
]


def get_tool_parser(name_or_template: Optional[str] = None):
    """Parser by explicit name, or sniffed from a chat template string."""
    if name_or_template in _PARSERS:
        return _PARSERS[name_or_template]()
    if name_or_template:
        for marker, family in _TEMPLATE_MARKERS:
            if marker in name_or_template:
                return _PARSERS[family]()
    return JsonToolParser()


def parse_tool_calls(text: str, parser=None) -> tuple:
    """Returns (clean_text, [ {name, arguments}, ... ])."""
    parser = parser or JsonToolParser()
    return parser.parse(text)
