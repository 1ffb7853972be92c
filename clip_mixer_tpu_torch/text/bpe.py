"""CLIP byte-level BPE tokenizer (host-side, pure Python, no ``regex``).

Counterpart of ``clip_mixer_tpu/text/bpe.py`` with the same semantics: ftfy
repair when ftfy is installed (identity otherwise), double HTML-unescape,
whitespace collapse, lowercase; the reference pre-tokenizer

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+        (case-insensitive)

written out by hand with ``unicodedata`` (``L*`` categories for \\p{L},
``N*`` for \\p{N}, Unicode White_Space for \\s); then the greedy
lowest-rank merge loop with a ``</w>`` end-of-word marker and a per-word
cache. The merge table is the port's copy of the reference's
``bpe_simple_vocab_16e6.txt.gz`` (``text/vocab/``, byte for byte the JAX
package's).
"""

from __future__ import annotations

import functools
import gzip
import html
import unicodedata
from pathlib import Path
from typing import Dict, List, Tuple

try:  # ftfy is optional; identity otherwise.
    import ftfy

    _fix_text = ftfy.fix_text
except ImportError:  # pragma: no cover - environment dependent
    def _fix_text(s: str) -> str:
        return s

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
_END = "</w>"
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Case-insensitive matching folds U+017F LATIN SMALL LETTER LONG S onto "s"
# (the only non-ASCII character that matches a letter of the literals above
# once the text is lowercased).
_FOLD = str.maketrans({"ſ": "s"})
# str.isspace() is Unicode White_Space plus U+001C..U+001F, which \s omits.
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")
# U+0345 COMBINING GREEK YPOGEGRAMMENI is no letter, but under case-insensitive
# matching it is a case variant of a letter (iota), so the negated class
# [^\s\p{L}\p{N}] refuses it too: no alternative matches it and it splits
# the runs around it like white space.
_CASE_VARIANT_OF_LETTER = "\u0345"


@functools.lru_cache()
def default_vocab_path() -> str:
    return str(Path(__file__).resolve().parent / "vocab" / "bpe_simple_vocab_16e6.txt.gz")


def _is_space(ch: str) -> bool:
    return ch.isspace() and ch not in _NOT_WHITE_SPACE


def _is_gap(ch: str) -> bool:
    return _is_space(ch) or ch == _CASE_VARIANT_OF_LETTER


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def pretokenize(text: str) -> List[str]:
    """The reference pre-tokenizer's ``findall`` over ``text``."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        matched = None
        if ch == "<":
            for special in (SOT, EOT):
                if text[i : i + len(special)].lower().translate(_FOLD) == special:
                    matched = text[i : i + len(special)]
                    break
        elif ch == "'":
            for c in _CONTRACTIONS:
                if text[i : i + len(c)].lower().translate(_FOLD) == c:
                    matched = text[i : i + len(c)]
                    break
        if matched is not None:
            out.append(matched)
            i += len(matched)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
            out.append(text[i:j])
            i = j
        elif _is_number(ch):
            out.append(ch)
            i += 1
        elif _is_gap(ch):
            i += 1
        else:
            j = i + 1
            while j < n and not (_is_gap(text[j]) or _is_letter(text[j]) or _is_number(text[j])):
                j += 1
            out.append(text[i:j])
            i = j
    return out


@functools.lru_cache()
def byte_symbol_table() -> Dict[int, str]:
    """Invertible byte -> printable-unicode map (GPT-2 scheme)."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    table: Dict[int, str] = {b: chr(b) for b in keep}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + offset)
            offset += 1
    return table


def normalize_text(text: str) -> str:
    """Cleanup applied before pre-tokenisation."""
    text = _fix_text(text)
    text = html.unescape(html.unescape(text)).strip()
    out: List[str] = []
    in_space = False
    for ch in text:  # collapse each run of \s to one space
        if _is_space(ch):
            if not in_space:
                out.append(" ")
            in_space = True
        else:
            out.append(ch)
            in_space = False
    return "".join(out).strip().lower()


class ClipBPE:
    """Greedy byte-level BPE with the CLIP merge table."""

    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or default_vocab_path()
        with gzip.open(vocab_path) as f:
            lines = f.read().decode("utf-8").split("\n")
        # Line 0 is a version header; the merge list is cut so the vocab is 49,408.
        n_merges = 49152 - 256 - 2
        merge_pairs: List[Tuple[str, str]] = []
        for line in lines[1 : 1 + n_merges]:
            a, b = line.split()
            merge_pairs.append((a, b))

        base = list(byte_symbol_table().values())
        tokens = base + [s + _END for s in base]
        tokens += ["".join(p) for p in merge_pairs]
        tokens += [SOT, EOT]
        self.token_to_id: Dict[str, int] = {t: i for i, t in enumerate(tokens)}
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.token_to_id.items()}
        self.rank: Dict[Tuple[str, str], int] = {p: i for i, p in enumerate(merge_pairs)}
        self._byte_enc = byte_symbol_table()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        self._cache: Dict[str, List[str]] = {SOT: [SOT], EOT: [EOT]}

    def clear_cache(self) -> None:
        self._cache = {SOT: [SOT], EOT: [EOT]}

    @property
    def vocab_size(self) -> int:
        return len(self.token_to_id)

    @property
    def sot_id(self) -> int:
        return self.token_to_id[SOT]

    @property
    def eot_id(self) -> int:
        return self.token_to_id[EOT]

    def _merge_word(self, token: str) -> List[str]:
        """Apply merges greedily by ascending rank."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        symbols = list(token[:-1]) + [token[-1] + _END]
        while len(symbols) > 1:
            best_rank = None
            best_pos = -1
            for i in range(len(symbols) - 1):
                r = self.rank.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_pos = r, i
            if best_rank is None:
                break
            first, second = symbols[best_pos], symbols[best_pos + 1]
            # Merge every adjacent occurrence of this pair in one sweep.
            out: List[str] = []
            i = 0
            while i < len(symbols):
                if i < len(symbols) - 1 and symbols[i] == first and symbols[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out
        self._cache[token] = symbols
        return symbols

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for raw in pretokenize(normalize_text(text)):
            mapped = "".join(self._byte_enc[b] for b in raw.encode("utf-8"))
            ids.extend(self.token_to_id[s] for s in self._merge_word(mapped))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.id_to_token[int(i)] for i in ids)
        data = bytearray(self._byte_dec[c] for c in text if c in self._byte_dec)
        return data.decode("utf-8", errors="replace").replace(_END, " ")


@functools.lru_cache()
def get_tokenizer() -> ClipBPE:
    return ClipBPE()
