"""Stopping criteria (host-side).

Port of mlx_vlm_tpu/core/stopping.py (StoppingCriteria :12), unchanged:
EOS token ids and stop strings tracked over a streamed generation; a stop
string is searched in the tail of the text fed so far (the longest stop
string plus 16 characters).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

__all__ = ["StoppingCriteria"]


class StoppingCriteria:
    """Tracks EOS token ids and stop strings over a streamed generation."""

    def __init__(self, eos_token_ids: Iterable[int] = (),
                 stop_words: Sequence[str] = (), tokenizer=None):
        self.eos_ids = set(int(t) for t in eos_token_ids)
        self.stop_words = list(stop_words or [])
        self.tokenizer = tokenizer
        self._tail = ""
        self._max_stop = max((len(s) for s in self.stop_words), default=0)

    def reset(self) -> None:
        self._tail = ""

    def add_eos_token(self, token: "str | int") -> None:
        """An id joins the EOS ids; a string that the tokenizer encodes as
        one token adds that token's id, any other becomes a stop string
        (without a tokenizer a string is ignored)."""
        if isinstance(token, int):
            self.eos_ids.add(token)
        elif self.tokenizer is not None:
            ids = self.tokenizer.encode(token, add_special_tokens=False)
            if len(ids) == 1:
                self.eos_ids.add(ids[0])
            else:
                self.stop_words.append(token)
                self._max_stop = max(self._max_stop, len(token))

    def is_eos(self, token_id: int) -> bool:
        return token_id in self.eos_ids

    def check_text(self, new_text: str) -> Optional[str]:
        """Feed newly generated text; returns the matched stop string."""
        if not self.stop_words:
            return None
        self._tail = (self._tail + new_text)[-(self._max_stop + 16):]
        for s in self.stop_words:
            if s in self._tail:
                return s
        return None
