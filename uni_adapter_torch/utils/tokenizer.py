"""CLIP byte-level BPE tokenizer (mirror of `uni_adapter_tpu/utils/
tokenizer.py`): the public bpe_simple_vocab_16e6 merge table (shipped in
assets/), lower-cased text, <|startoftext|>/<|endoftext|> specials and a
fixed 77-token context.

The standard tokenizer splits text with the third-party `regex` package
(`[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+` under IGNORECASE).  This copy
uses the standard library's `re` with the same split:

  * the letter and number classes are built once from
    `unicodedata.category` (first letter L or N).  Python's `\\w` would
    not do: it counts the other numerics (Nl, No: `²`, `½`, `Ⅻ`) as word
    characters, which `\\p{N}` emits one at a time;
  * whitespace is `str.isspace` without U+001C–U+001F, which `regex`'s
    `\\s` leaves out;
  * only the specials and the contractions are case-insensitive (so
    `'ſ` is `'s`, as under `regex`'s IGNORECASE), while the classes are
    not: under IGNORECASE U+0345 (a combining mark that case-folds to a
    letter) falls in none of the three classes and is dropped, as here.

The classes follow this Python's Unicode tables; `regex` may carry a
newer version, so the two can differ on code points that Python's tables
leave unassigned.  Without ftfy (absent here, as in the JAX package's
environment) `basic_clean` only unescapes HTML.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import List, Union

import numpy as np

DEFAULT_BPE_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                "assets", "bpe_simple_vocab_16e6.txt.gz")

CONTEXT_LENGTH = 77

#: Case-folds to a letter, so `regex`'s IGNORECASE keeps it out of all
#: three classes.
_DROPPED = "ͅ"


def _char_class(chars) -> str:
    """A `re` character class of `chars` (sorted code points) as ranges."""
    parts, cps = [], list(chars)
    i = 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        lo, hi = re.escape(chr(cps[i])), re.escape(chr(cps[j]))
        parts.append(lo if i == j else f"{lo}-{hi}")
        i = j + 1
    return "".join(parts)


@functools.lru_cache()
def _classes() -> tuple[str, str, str]:
    """(letters, numbers, whitespace) as `re` class bodies."""
    letters, numbers, space = [], [], []
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        if c == _DROPPED:
            continue
        cat = unicodedata.category(c)[0]
        if cat == "L":
            letters.append(cp)
        elif cat == "N":
            numbers.append(cp)
        elif c.isspace() and not 0x1C <= cp <= 0x1F:
            space.append(cp)
    return _char_class(letters), _char_class(numbers), _char_class(space)


@functools.lru_cache()
def _whitespace_re() -> re.Pattern:
    return re.compile(f"[{_classes()[2]}]+")


@functools.lru_cache()
def bytes_to_unicode() -> dict:
    """Reversible byte → printable-unicode map (standard GPT-2/CLIP table)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def get_pairs(word: tuple) -> set:
    return {(a, b) for a, b in zip(word, word[1:])}


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return _whitespace_re().sub(" ", text).strip()


class SimpleTokenizer:
    """CLIP BPE tokenizer with the reference's vocab layout: 256 byte tokens,
    256 </w> variants, 48894 merges, then the two specials (49408 total)."""

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = bytes_to_unicode()
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        letters, numbers, space = _classes()
        self.pat = re.compile(
            r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll"
            rf"|'d)|[{letters}]+|[{numbers}]"
            rf"|[^{space}{letters}{numbers}{_DROPPED}]+")

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
            new_word: list = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
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
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self.bpe(token).split(" "))
        return bpe_tokens

    def __call__(self, texts: Union[str, List[str]],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """(B, 77) int32 ids with SOT/EOT, zero-padded.  Truncation is a
        plain cut at the context length, so EOT is dropped when it falls
        off the end, as in the reference (the text tower's argmax pooling
        then takes the highest id left)."""
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = ([sot] + self.encode(text) + [eot])[:context_length]
            result[i, :len(tokens)] = tokens
        return result


def tokenize(texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Module-level convenience mirroring clip.tokenize."""
    return _default_tokenizer()(texts, context_length)


@functools.lru_cache()
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()
