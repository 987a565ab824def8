"""The hash tokenizer, a frozen copy of the port's
(``miner_tpu_torch/data/tokenization.py:HashTokenizer``): words and
punctuation, each lower-cased and hashed by blake2s into one of the
vocabulary's ids above the four special ones; ``[CLS] tokens [SEP]`` cut
to the field's length."""
from __future__ import annotations

import hashlib
import re
from typing import List

_WORD_RE = re.compile(r"\w+|[^\w\s]")
PAD, CLS, SEP = 0, 1, 2
SPECIAL = 4


class HashTokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self._ids = {}

    def _token_id(self, token: str) -> int:
        tid = self._ids.get(token)
        if tid is None:
            h = hashlib.blake2s(token.lower().encode("utf-8"), digest_size=4).digest()
            tid = SPECIAL + int.from_bytes(h, "little") % (self.vocab_size - SPECIAL)
            self._ids[token] = tid
        return tid

    def encode(self, text: str, max_length: int) -> List[int]:
        ids = [CLS] + [self._token_id(t) for t in _WORD_RE.findall(text or "")]
        return ids[: max_length - 1] + [SEP]
