"""Tokenizers: a HuggingFace adapter and a dependency-free hash tokenizer.

The port's own copy of ``miner_tpu/data/tokenization.py``: the same ids for
the same text, so both packages build the same token tables.

The reference relies on ``AutoTokenizer.from_pretrained`` (reference:
src/trainer.py:28); this module keeps that path (``load_tokenizer`` with a
local checkpoint directory) but also provides ``HashTokenizer`` — a
deterministic, vocabulary-free tokenizer for tests, fixtures, and benchmarks
in environments without tokenizer files.  Both expose the same small protocol:
``encode(text, max_length)`` producing ``[cls] ... [sep/eos]`` sequences plus
the special-token ids the data layer needs.
"""
from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Protocol, runtime_checkable


@runtime_checkable
class Tokenizer(Protocol):
    cls_token_id: int
    pad_token_id: int
    sep_token_id: int
    eos_token_id: Optional[int]
    vocab_size: int

    def encode(self, text: str, max_length: int) -> List[int]: ...


_WORD_RE = re.compile(r"\w+|[^\w\s]")


class HashTokenizer:
    """Deterministic hash-bucket word tokenizer.

    Splits on word boundaries and maps each lowercased token to a stable
    bucket via blake2; ids 0..3 are reserved for pad/cls/sep/unk (mirroring
    a BERT-style layout where pad=0).
    """

    def __init__(self, vocab_size: int = 30522):
        assert vocab_size > 16
        self.vocab_size = vocab_size
        self.pad_token_id = 0
        self.cls_token_id = 1
        self.sep_token_id = 2
        self.unk_token_id = 3
        self.eos_token_id = None  # BERT-style: sep closes the sequence
        self._n_special = 4

    def _token_id(self, token: str) -> int:
        h = hashlib.blake2s(token.lower().encode("utf-8"), digest_size=4).digest()
        bucket = int.from_bytes(h, "little") % (self.vocab_size - self._n_special)
        return self._n_special + bucket

    def encode(self, text: str, max_length: int) -> List[int]:
        tokens = _WORD_RE.findall(text or "")
        ids = [self.cls_token_id] + [self._token_id(t) for t in tokens]
        ids = ids[: max_length - 1] + [self.sep_token_id]
        return ids


class HFTokenizerAdapter:
    """Wraps a transformers tokenizer behind the small protocol."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer
        self.cls_token_id = hf_tokenizer.cls_token_id
        self.pad_token_id = hf_tokenizer.pad_token_id
        self.sep_token_id = hf_tokenizer.sep_token_id
        self.eos_token_id = hf_tokenizer.eos_token_id
        self.vocab_size = hf_tokenizer.vocab_size

    def encode(self, text: str, max_length: int) -> List[int]:
        return self._tok.encode(
            text, add_special_tokens=True, truncation=True, max_length=max_length
        )


def load_tokenizer(name_or_path: str, vocab_size: int = 30522) -> Tokenizer:
    """Load an HF tokenizer from local files if available, else fall back to
    HashTokenizer. Never downloads: a hub name without local files falls
    back too.

    ``hash`` or ``hash:<vocab_size>`` selects the hash tokenizer explicitly.
    """
    if name_or_path.startswith("hash"):
        if ":" in name_or_path:
            vocab_size = int(name_or_path.split(":", 1)[1])
        return HashTokenizer(vocab_size)
    try:
        from transformers import AutoTokenizer

        return HFTokenizerAdapter(
            AutoTokenizer.from_pretrained(name_or_path, local_files_only=True))
    except Exception as e:  # no network / no files: degrade loudly but usably
        import logging

        logging.getLogger(__name__).warning(
            "could not load HF tokenizer %r (%s); falling back to HashTokenizer",
            name_or_path,
            e,
        )
        return HashTokenizer(vocab_size)
