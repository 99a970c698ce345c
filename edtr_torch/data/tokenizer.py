"""CLIP BPE tokenizer (host side) of the port.

Counterpart of ``edtr_tpu/data/tokenizer.py``: the OpenAI/OpenCLIP
``SimpleTokenizer`` algorithm. The BPE merge table is data: the port's own
copy, ``bpe_simple_vocab_16e6.txt.gz`` beside this file (identical in every
CLIP distribution), or a path given in ``$EDTR_BPE_PATH`` or the
``bpe_path`` argument.

The EDTR configs only use the empty prompt, and ``""`` tokenizes to
``[SOT, EOT, 0, ...]`` without the merge table.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import List, Optional, Sequence, Union

import numpy as np

try:
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

CONTEXT_LENGTH = 77
SOT_TEXT = "<start_of_text>"
EOT_TEXT = "<end_of_text>"

DEFAULT_BPE_PATHS = [
    os.environ.get("EDTR_BPE_PATH", ""),
    # the port's copy (identical in every CLIP distribution)
    os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz"),
]


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> unicode mapping (standard GPT-2/CLIP table)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = self._load_merges(bpe_path)
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        try:  # unicode classes need the `regex` module; ascii fallback otherwise
            self.pat = re.compile(
                r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                re.IGNORECASE,
            )
        except re.error:
            self.pat = re.compile(
                r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
                re.IGNORECASE,
            )
        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]

    @staticmethod
    def _load_merges(bpe_path: Optional[str]):
        paths = [bpe_path] if bpe_path else DEFAULT_BPE_PATHS
        for p in paths:
            if p and os.path.exists(p):
                with gzip.open(p, "rt", encoding="utf-8") as f:
                    lines = f.read().split("\n")
                lines = lines[1 : 49152 - 256 - 2 + 1]
                return [tuple(line.split()) for line in lines]
        return []  # empty-prompt-only mode

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        if text and not self.bpe_ranks:
            raise RuntimeError(
                "BPE merge table not found; set $EDTR_BPE_PATH to a "
                "bpe_simple_vocab_16e6.txt.gz (empty prompts work without it)."
            )
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


_default_tokenizer: Optional[SimpleTokenizer] = None


def get_tokenizer() -> SimpleTokenizer:
    global _default_tokenizer
    if _default_tokenizer is None:
        _default_tokenizer = SimpleTokenizer()
    return _default_tokenizer


def tokenize(
    texts: Union[str, Sequence[str]], context_length: int = CONTEXT_LENGTH
) -> np.ndarray:
    """Batch-tokenize: int32 (len(texts), context_length); over-long
    inputs truncate with EOT forced at the last slot."""
    if isinstance(texts, str):
        texts = [texts]
    tk = get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tk.sot_token] + tk.encode(text) + [tk.eot_token]
        if len(tokens) > context_length:
            tokens = tokens[:context_length]
            tokens[-1] = tk.eot_token
        result[i, : len(tokens)] = tokens
    return result
