"""State store for the OpenAI Responses API.

Port of mlx_vlm_tpu/server/responses_state.py, verbatim: response
retrieval, input_items, previous_response_id chaining.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional


class ResponsesStateStore:
    def __init__(self, max_entries: int = 512):
        self.lock = threading.Lock()
        self.max_entries = max_entries
        self._responses: "OrderedDict[str, dict]" = OrderedDict()
        self._inputs: Dict[str, List[dict]] = {}

    def new_id(self) -> str:
        return f"resp_{uuid.uuid4().hex[:24]}"

    def put(self, response: dict, input_items: List[dict]):
        with self.lock:
            rid = response["id"]
            self._responses[rid] = response
            self._inputs[rid] = input_items
            while len(self._responses) > self.max_entries:
                old, _ = self._responses.popitem(last=False)
                self._inputs.pop(old, None)

    def get(self, rid: str) -> Optional[dict]:
        with self.lock:
            return self._responses.get(rid)

    def input_items(self, rid: str) -> Optional[List[dict]]:
        with self.lock:
            return self._inputs.get(rid)

    def delete(self, rid: str) -> bool:
        with self.lock:
            self._inputs.pop(rid, None)
            return self._responses.pop(rid, None) is not None

    def conversation_chain(self, rid: str) -> List[dict]:
        """Reconstruct messages from a previous_response_id chain."""
        out: List[dict] = []
        seen = set()
        while rid and rid not in seen:
            seen.add(rid)
            resp = self.get(rid)
            if resp is None:
                break
            items = self.input_items(rid) or []
            assistant = [
                {
                    "role": "assistant",
                    "content": "".join(
                        c.get("text", "")
                        for o in resp.get("output", [])
                        for c in o.get("content", [])
                    ),
                }
            ]
            out = items + assistant + out
            rid = resp.get("previous_response_id")
        return out
