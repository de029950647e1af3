"""Self-contained CLIP byte-pair-encoding tokenizer.

Replaces the pip `clip` package's tokenizer (the reference depends on it via
`clip.tokenize`, e.g. reference models/clip_encoders.py:60).  Runs entirely on
the host; token ids are the only thing that crosses to the device (a fixed
(N, 77) int32 array).

The standard CLIP merges file (`bpe_simple_vocab_16e6.txt.gz`) is loaded from a
user-supplied path when available, giving vocabulary parity with OpenAI CLIP
(49408 tokens, context length 77).  When no merges file is present, a deterministic byte-level fallback vocabulary
is built (256 byte tokens + 256 word-final byte tokens + 2 specials = 514
tokens); every pipeline still runs end-to-end, only checkpoint-parity with
OpenAI weights requires the real merges file.

No `ftfy` dependency: text cleaning is html-unescape + whitespace folding,
which is equivalent for the ASCII class names used by all FRAMED datasets.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Sequence

import numpy as np
import regex as re

CONTEXT_LENGTH = 77

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> unicode-codepoint table (standard byte-level BPE)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """CLIP BPE tokenizer.

    :param bpe_path: path to `bpe_simple_vocab_16e6.txt.gz`. If None or
        missing, builds the byte-level fallback vocabulary.
    """

    def __init__(self, bpe_path: str | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges: list[tuple[str, str]] = []
        if bpe_path and os.path.exists(bpe_path):
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # Standard slice used with this merges file: skip the header line,
            # keep 49152-256-2 merge rules.
            lines = lines[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in lines if m]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: list[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def tokenize(
        self,
        texts: str | Sequence[str],
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = False,
    ) -> np.ndarray:
        """Tokenize into a fixed (N, context_length) int32 array.

        Mirrors `clip.tokenize` semantics: <sot> tokens <eot>, zero padding,
        error on overflow unless `truncate` (then the last token is <eot>).
        """
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > context_length:
                if truncate:
                    tokens = tokens[:context_length]
                    tokens[-1] = self.eot_token
                else:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {context_length}"
                    )
            result[i, : len(tokens)] = tokens
        return result


@functools.lru_cache(maxsize=4)
def get_tokenizer(bpe_path: str | None = None) -> ClipTokenizer:
    """Cached tokenizer factory. Falls back to $CLIP_BPE_PATH, then byte-level."""
    if bpe_path is None:
        bpe_path = os.environ.get("CLIP_BPE_PATH") or None
    return ClipTokenizer(bpe_path)
