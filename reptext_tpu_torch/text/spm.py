"""SentencePiece unigram encoder with a protobuf-free spiece.model reader.

A copy of ``reptext_tpu/text/spm.py``. It replaces the
``T5Tokenizer``/``sentencepiece`` dependency the reference pulls in through
the pipeline (RepText/pipeline_flux_controlnet.py:194-226,232-305: T5
sequence embeddings, <=512 tokens). The ``spiece.model`` file shipped with
FLUX checkpoints is a serialized SentencePiece ``ModelProto``; only the piece
list (field 1: piece/score/type) is needed for unigram inference, so it is
parsed directly from the protobuf wire format here (varint + length-delimited
records — stable, versioned wire layout).

Encoding follows SentencePiece unigram inference: NFKC normalization,
whitespace collapse, dummy-prefix + metaspace (U+2581), then Viterbi
segmentation maximizing the sum of piece log-probs, with unknown characters
scored at ``min_score - 10`` (the sentencepiece unk penalty).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

_METASPACE = "▁"
_UNK_PENALTY = 10.0

# SentencePiece piece types (sentencepiece_model.proto enum)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:      # varint
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:    # 64-bit
        pos += 8
    elif wire_type == 2:    # length-delimited
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:    # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return pos


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """Extract [(piece, score, type), ...] from a serialized ModelProto."""
    import struct

    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            n, pos = _read_varint(data, pos)
            end = pos + n
            piece, score, ptype = "", 0.0, NORMAL
            while pos < end:
                t2, pos = _read_varint(data, pos)
                f2, w2 = t2 >> 3, t2 & 7
                if f2 == 1 and w2 == 2:
                    ln, pos = _read_varint(data, pos)
                    piece = data[pos:pos + ln].decode("utf-8")
                    pos += ln
                elif f2 == 2 and w2 == 5:
                    (score,) = struct.unpack("<f", data[pos:pos + 4])
                    pos += 4
                elif f2 == 3 and w2 == 0:
                    ptype, pos = _read_varint(data, pos)
                else:
                    pos = _skip_field(data, pos, w2)
            pieces.append((piece, score, ptype))
        else:
            pos = _skip_field(data, pos, wire)
    return pieces


def normalize(text: str) -> str:
    """NFKC + whitespace collapse + dummy prefix + metaspace substitution."""
    text = unicodedata.normalize("NFKC", text)
    text = " ".join(text.split())
    return (_METASPACE + text.replace(" ", _METASPACE)) if text else ""


class SentencePieceUnigram:
    """Viterbi unigram encoder over a parsed piece table."""

    def __init__(self, pieces: Sequence[Tuple[str, float, int]]):
        self.pieces = list(pieces)
        self.piece_to_id: Dict[str, int] = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores = [s for (_, s, _) in pieces]
        self.unk_id = next(
            (i for i, (_, _, t) in enumerate(pieces) if t == UNKNOWN), 0)
        self.eos_id = self.piece_to_id.get("</s>")
        self.pad_id = self.piece_to_id.get("<pad>")
        # prefix lookup: pieces grouped by first char, longest-first
        self._by_first: Dict[str, List[Tuple[str, int, float]]] = {}
        self._max_len = 1
        for i, (p, s, t) in enumerate(pieces):
            if t in (UNKNOWN, CONTROL, UNUSED) or not p:
                continue
            self._by_first.setdefault(p[0], []).append((p, i, s))
            self._max_len = max(self._max_len, len(p))
        min_score = min(self.scores) if self.scores else 0.0
        self._unk_score = min_score - _UNK_PENALTY

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceUnigram":
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()))

    def _viterbi(self, s: str) -> List[int]:
        n = len(s)
        best = [float("-inf")] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            matched = False
            for p, pid, score in self._by_first.get(s[i], ()):
                if s.startswith(p, i):
                    j = i + len(p)
                    cand = best[i] + score
                    if cand > best[j]:
                        best[j] = cand
                        back[j] = (i, pid)
                    if len(p) == 1:
                        matched = True
            # unknown single char fallback (always available so Viterbi
            # never dead-ends on out-of-vocab characters)
            j = i + 1
            cand = best[i] + self._unk_score
            if not matched and cand > best[j]:
                best[j] = cand
                back[j] = (i, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            # sentencepiece fuses consecutive unknown characters into ONE unk
            if not (ids and pid == self.unk_id and ids[-1] == self.unk_id):
                ids.append(pid)
            pos = start
        return ids[::-1]

    def tokenize(self, text: str) -> List[str]:
        return [self.pieces[i][0] for i in self.encode(text, add_eos=False,
                                                       max_length=None)]

    def encode(
        self,
        text: str,
        max_length: Optional[int] = 512,
        add_eos: bool = True,
        pad_to_max: bool = False,
    ) -> List[int]:
        ids = self._viterbi(normalize(text))
        if add_eos and self.eos_id is not None:
            if max_length is not None:
                ids = ids[: max_length - 1]
            ids.append(self.eos_id)
        elif max_length is not None:
            ids = ids[:max_length]
        if pad_to_max and max_length is not None and self.pad_id is not None:
            ids += [self.pad_id] * (max_length - len(ids))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        skip = {self.eos_id, self.pad_id, self.unk_id}
        text = "".join(self.pieces[i][0] for i in ids
                       if i not in skip and 0 <= i < len(self.pieces))
        return text.replace(_METASPACE, " ").strip()
