"""Byte-level BPE tokenizer for CLIP (``jcf_tpu/tokenizer/bpe.py``).

Same cleaning (optional ftfy, double html-unescape, whitespace collapse,
lowercase), the same byte -> unicode map and the same merge table of the
``bpe_simple_vocab_16e6`` vocabulary (a byte-identical copy under
``jcf_tpu_torch/assets``), so the token ids are equal.

The JAX package pre-splits text with the ``regex`` module's pattern

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

under IGNORECASE. The port's hosts may lack ``regex``, and Python's ``re``
has no ``\\p{..}`` classes (``[^\\W\\d_]`` is not Unicode category L, and
its ``\\s`` also matches U+001C-U+001F), so ``split_words`` is a scanner
over ``unicodedata.category`` that tries the same alternatives in the same
order at each position. Two facts of ``regex`` it keeps:

- ``\\s`` is Unicode White_Space (``WHITESPACE``);
- under IGNORECASE a character matches a class if its case fold does:
  U+017F (long s) matches the ``s`` of the specials and of ``'s``, and
  U+0345 (combining ypogegrammeni, category Mn, folding to a letter)
  matches none of the three classes, so it splits words like whitespace.

Characters unassigned in the interpreter's Unicode database (category
Cn) count as neither letter nor number; ``regex`` may ship a newer
Unicode version that assigns some of them.
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Tuple

try:  # ftfy fixes mojibake; optional exactly as in the JAX package
    import ftfy

    _fix_text = ftfy.fix_text
except ImportError:  # pragma: no cover

    def _fix_text(text: str) -> str:
        return text

N_BYTE_SYMBOLS = 256
N_SPECIALS = 2
VOCAB_SIZE = 49408
N_MERGES = VOCAB_SIZE - 2 * N_BYTE_SYMBOLS - N_SPECIALS  # 48894

_WORD_END = "</w>"
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
# the alternatives before the classes, in the pattern's order
_LITERALS = _SPECIALS + ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Unicode White_Space, the ``regex`` module's ``\s``
WHITESPACE = frozenset(
    [*map(chr, range(0x09, 0x0E)), " ", "\x85", "\xa0", "\u1680",
     *map(chr, range(0x2000, 0x200B)), "\u2028", "\u2029", "\u202f", "\u205f", "\u3000"]
)
# characters that match no alternative: whitespace and U+0345
_SKIP = WHITESPACE | {"\u0345"}
_LETTER, _NUMBER, _OTHER, _NONE = range(4)


def default_vocab_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """Invertible map from bytes to printable code points: printable latin
    ranges map to themselves, the other bytes to 256, 257, ..."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    mapping: Dict[int, str] = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _collapse_whitespace(text: str) -> str:
    """Each run of WHITESPACE -> one space (``regex.sub(r"\\s+", " ", text)``)."""
    out: List[str] = []
    prev_ws = False
    for ch in text:
        ws = ch in WHITESPACE
        if not (ws and prev_ws):
            out.append(" " if ws else ch)
        prev_ws = ws
    return "".join(out)


def clean_text(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    return _collapse_whitespace(text).strip()


def _kind(ch: str) -> int:
    if ch in _SKIP:
        return _NONE
    cat = unicodedata.category(ch)[0]
    if cat == "L":
        return _LETTER
    if cat == "N":
        return _NUMBER
    return _OTHER


def _literal_at(text: str, i: int) -> int:
    """Length of the first literal alternative matching at ``i`` under
    IGNORECASE, or 0."""
    for lit in _LITERALS:
        if len(text) - i < len(lit):
            continue
        for k, c in enumerate(lit):
            t = text[i + k]
            if t != c and t != c.upper() and not (c == "s" and t == "\u017f"):
                break
        else:
            return len(lit)
    return 0


def split_words(text: str) -> List[str]:
    """The pre-split: what ``regex.findall`` of the JAX package's pattern
    returns on ``text``."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        j = i + _literal_at(text, i)
        if j == i:
            kind = _kind(text[i])
            if kind == _NONE:
                i += 1
                continue
            j = i + 1
            if kind != _NUMBER:  # letters and "other" run; a number is one char
                while j < n and _kind(text[j]) == kind:
                    j += 1
        out.append(text[i:j])
        i = j
    return out


def _adjacent_pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word, word[1:]))


class SimpleTokenizer:
    """CLIP byte-level BPE codec: text <-> token id lists."""

    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or default_vocab_path()
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(vocab_path) as f:
            lines = f.read().decode("utf-8").split("\n")
        # line 0 is a header; keep exactly N_MERGES merge rules
        merges = [tuple(line.split()) for line in lines[1 : N_MERGES + 1]]
        self.merge_rank: Dict[Tuple[str, str], int] = {pair: r for r, pair in enumerate(merges)}
        symbols: List[str] = list(self.byte_encoder.values())
        symbols += [s + _WORD_END for s in symbols]
        symbols += ["".join(pair) for pair in merges]
        symbols += list(_SPECIALS)
        if len(symbols) != VOCAB_SIZE:
            raise ValueError(f"{vocab_path}: {len(symbols)} symbols, expected {VOCAB_SIZE}")
        self.encoder: Dict[str, int] = {s: i for i, s in enumerate(symbols)}
        self.decoder: Dict[int, str] = {i: s for s, i in self.encoder.items()}
        self._bpe_cache: Dict[str, str] = {s: s for s in _SPECIALS}

    @property
    def vocab_size(self) -> int:
        return VOCAB_SIZE

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        """Apply the merge rules to one pre-split word (already byte-mapped)."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + _WORD_END,)
        pairs = _adjacent_pairs(word)
        if not pairs:
            return token + _WORD_END
        while True:
            best = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if best not in self.merge_rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _adjacent_pairs(word)
        result = " ".join(word)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in split_words(clean_text(text).lower()):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[unit] for unit in self.bpe(mapped).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[ch] for ch in text)
        return raw.decode("utf-8", errors="replace").replace(_WORD_END, " ")


@lru_cache()
def get_tokenizer(vocab_path: str | None = None) -> SimpleTokenizer:
    """Process-wide shared tokenizer instance."""
    return SimpleTokenizer(vocab_path)
