"""Pure-Python CLIP byte-BPE tokenizer (vocab.json + merges.txt).

A copy of ``reptext_tpu/text/clip_bpe.py`` with one change: the JAX package
splits words with the ``regex`` module's ``\\p{L}``/``\\p{N}`` classes, which
the port does not depend on; :func:`split_words` makes the same split with
``unicodedata`` categories. It replaces the ``transformers.CLIPTokenizer``
dependency the reference pulls in through the pipeline
(RepText/pipeline_flux_controlnet.py:194-226,308-347). Loads the exact HF
tokenizer files shipped with FLUX checkpoints (``tokenizer/vocab.json``,
``tokenizer/merges.txt``) and reproduces the HF slow-tokenizer output: basic
cleanup + lowercase normalization, the CLIP word/number/punctuation split,
GPT-2 byte-to-unicode mapping, and rank-greedy BPE with the ``</w>``
end-of-word marker.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

# the literal alternatives of CLIP's word pattern, tried in its order
_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(ch: str) -> str:
    """'L' (a letter, \\p{L}), 'N' (a number, \\p{N}), ' ' (white space) or
    'P' (anything else: punctuation, symbols, marks)."""
    if ch.isspace():
        return " "
    major = unicodedata.category(ch)[0]
    return major if major in "LN" else "P"


def split_words(text: str) -> List[str]:
    """CLIP's word split of cleaned (lower-case) text: the matches of
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
    [^\\s\\p{L}\\p{N}]+``, left to right, white space skipped."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        kind = _char_class(text[i])
        if kind == " ":
            i += 1
            continue
        lit = next((w for w in _LITERALS if text.startswith(w, i)), None)
        if lit is not None:
            words.append(lit)
            i += len(lit)
            continue
        j = i + 1
        if kind != "N":             # one number character; runs of letters or of the rest
            while j < n and _char_class(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map (standard algorithm)."""
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
    return dict(zip(bs, map(chr, cs)))


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _basic_clean(text: str) -> str:
    """Control-char removal + CJK spacing + lowercase + whitespace collapse.

    Mirrors the HF slow tokenizer's no-ftfy path (BasicTokenizer with
    strip_accents=False, do_split_on_punc=False, then whitespace_clean+lower);
    on already-clean text this matches the ftfy path too.
    """
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C") and ch not in ("\t", "\n", "\r"):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif ch.isspace():
            out.append(" ")
        else:
            out.append(ch)
    return " ".join("".join(out).split()).lower()


class CLIPBPETokenizer:
    """CLIP-L/14 tokenizer; ids match HF ``CLIPTokenizer`` on the same files."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 bos_token: str = "<|startoftext|>",
                 eos_token: str = "<|endoftext|>"):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        self._cache: Dict[str, str] = {}

    @classmethod
    def from_dir(cls, path: str) -> "CLIPBPETokenizer":
        """Load from an HF checkpoint tokenizer dir (vocab.json, merges.txt)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        # first line is the "#version" header; HF also caps the merge count
        merges = [tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1]]
        return cls(vocab, merges)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            self._cache[token] = word[0]
            return word[0]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        text = _basic_clean(text)
        tokens: List[str] = []
        for tok in split_words(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self._bpe(mapped).split(" "))
        return tokens

    def encode(
        self,
        text: str,
        max_length: Optional[int] = 77,
        pad_to_max: bool = True,
    ) -> List[int]:
        """bos + tokens + eos, truncated and eos-padded to ``max_length``
        (CLIP pads with the eos token, matching HF pad_token)."""
        ids = [self.bos_token_id]
        ids += [self.encoder.get(t, self.eos_token_id) for t in self.tokenize(text)]
        if max_length is not None:
            ids = ids[: max_length - 1]
        ids.append(self.eos_token_id)
        if pad_to_max and max_length is not None:
            ids += [self.eos_token_id] * (max_length - len(ids))
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        special = {self.bos_token_id, self.eos_token_id}
        text = "".join(
            self.decoder[i] for i in ids
            if not (skip_special and i in special) and i in self.decoder
        )
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
