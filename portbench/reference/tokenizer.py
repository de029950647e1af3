"""CLIP's tokenizer without its BPE merges file, for lowercase ASCII words.

Without the merges file CLIP's byte-level BPE keeps every character a token:
byte b's token is its place in the byte-to-unicode table (printable ASCII
'!'..'~' first, so a lowercase letter c is ord(c) - 33), a word's last
character takes the end-of-word form (+256), and <|startoftext|> and
<|endoftext|> are 512 and 513.  Text is lowercased and split on whitespace;
`tokenize` pads with zeros to the context length, as `clip.tokenize` does.

The benchmark's class names and templates are lowercase letters and spaces
only, which is all this frozen copy takes.
"""

from __future__ import annotations

import re

import numpy as np

SOT, EOT = 512, 513
_WORD = re.compile(r"^[a-z]+$")


def encode(text: str):
    out = []
    for word in text.lower().split():
        if not _WORD.match(word):
            raise ValueError(f"the reference tokenizer takes lowercase letters only: {word!r}")
        out += [ord(c) - 33 for c in word[:-1]] + [256 + ord(word[-1]) - 33]
    return out


def tokenize(texts, context_length: int = 77) -> np.ndarray:
    ids = np.zeros((len(texts), context_length), np.int64)
    for i, t in enumerate(texts):
        tok = [SOT] + encode(t) + [EOT]
        if len(tok) > context_length:
            raise ValueError(f"{t!r} is longer than {context_length} tokens")
        ids[i, : len(tok)] = tok
    return ids


def truncate(ids: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Drop the all-padding positions after the last end-of-text token,
    keeping a multiple of `multiple`."""
    last = int(ids.argmax(axis=-1).max())
    return ids[:, : min(ids.shape[1], -(-(last + 1) // multiple) * multiple)]


def coop_prompts(classes, prefix_len: int):
    """CoOp's 'X X .. X <class>' prompts (the prefix overwrites the X's)."""
    return [" ".join(["X"] * prefix_len + c.split("_")) for c in classes]


def template_prompts(classes, template: str = "a photo of a {}"):
    return [template.format(" ".join(c.split("_"))) for c in classes]
