"""SentencePiece-compatible unigram tokenizer.

The port's own copy of ``rnnt_tpu/data/tokenizer.py``: it reads a
SentencePiece ``.model`` protobuf directly (only the pieces list) or an
id->piece JSON, encodes by Viterbi over the piece scores with a
dummy-prefix space and U+2581 word-boundary pieces (unknown characters
score min_score - 10, runs of them fuse into one <unk>), and decodes by
joining pieces.  Encoding runs in the C++ tokenizer of
``rnnt_tpu_torch/native`` when g++ could build it, else in Python, as in
the JAX package; ``UnigramTokenizer.native`` says which.
"""

from __future__ import annotations

import ctypes
import json
import struct
from pathlib import Path

from rnnt_tpu_torch.native import load_native

# SentencePiece piece types (sentencepiece_model.proto).
_NORMAL = 1
_UNKNOWN = 2
_CONTROL = 3
_USER_DEFINED = 4
_UNUSED = 5
_BYTE = 6

_WS = "▁"  # ▁


def _parse_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _parse_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _parse_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _parse_piece(buf: bytes) -> tuple[str, float, int]:
    """Parse one SentencePiece message: (piece, score, type)."""
    piece, score, ptype = "", 0.0, _NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _parse_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            ln, pos = _parse_varint(buf, pos)
            piece = buf[pos:pos + ln].decode("utf-8")
            pos += ln
        elif field == 2 and wt == 5:
            (score,) = struct.unpack("<f", buf[pos:pos + 4])
            pos += 4
        elif field == 3 and wt == 0:
            ptype, pos = _parse_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wt)
    return piece, score, ptype


def parse_spm_model(path: str | Path) -> list[tuple[str, float, int]]:
    """Parse a SentencePiece .model file; returns [(piece, score, type)]."""
    buf = Path(path).read_bytes()
    pieces = []
    pos = 0
    while pos < len(buf):
        tag, pos = _parse_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:  # repeated SentencePiece pieces = 1
            ln, pos = _parse_varint(buf, pos)
            pieces.append(_parse_piece(buf[pos:pos + ln]))
            pos += ln
        else:
            pos = _skip_field(buf, pos, wt)
    return pieces


class UnigramTokenizer:
    """Viterbi unigram encoder/decoder over a SentencePiece piece table."""

    def __init__(self, pieces: list[tuple[str, float, int]]):
        self.pieces = pieces
        self.id_to_piece = [p for p, _, _ in pieces]
        self.piece_to_id = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores = [s for _, s, _ in pieces]
        self.unk_id = next(
            (i for i, (_, _, t) in enumerate(pieces) if t == _UNKNOWN), 0)
        # Pieces usable in segmentation (normal + user-defined + byte).
        self._seg = {
            p: (i, s) for i, (p, s, t) in enumerate(pieces)
            if t in (_NORMAL, _USER_DEFINED, _BYTE)
        }
        self._max_piece_len = max((len(p) for p in self._seg), default=1)
        # SentencePiece scores an unknown character min_score - 10 (not the
        # <unk> piece's own score), so known pieces win when available.
        min_score = min((s for _, (_, s) in self._seg.items()), default=0.0)
        self._unk_score = min_score - 10.0
        self._native = None
        self._init_native()

    @property
    def native(self) -> bool:
        """Whether ``encode`` runs in the C++ tokenizer."""
        return self._native is not None

    def _init_native(self) -> None:
        """Hand the segmentable pieces to the C++ tokenizer (the piece
        table wire format of ``native/tokenizer.cc``); without a library
        ``encode`` stays in Python."""
        lib = load_native()
        if lib is None:
            return
        parts = [struct.pack("<i", len(self._seg))]
        for piece, (pid, score) in self._seg.items():
            raw = piece.encode("utf-8")
            parts.append(struct.pack("<ifi", pid, score, len(raw)) + raw)
        blob = b"".join(parts)
        handle = lib.rnnt_tok_create(blob, len(blob), self.unk_id, self._unk_score)
        if handle:
            self._native = (lib, handle)

    @classmethod
    def from_file(cls, path: str | Path) -> "UnigramTokenizer":
        return cls(parse_spm_model(path))

    @classmethod
    def from_vocab_json(cls, path: str | Path) -> "UnigramTokenizer":
        """Load from the exported id→piece JSON (serving interchange)."""
        return cls.from_table(json.loads(Path(path).read_text()))

    @classmethod
    def from_table(cls, table: dict) -> "UnigramTokenizer":
        """From an id -> piece table (``vocab_json``'s content)."""
        items = sorted(((int(k), v) for k, v in table.items()))
        pieces = [(p, 0.0, _NORMAL) for _, p in items]
        return cls(pieces)

    def vocab_size(self) -> int:
        return len(self.pieces)

    def _normalize(self, text: str) -> str:
        # Dummy prefix + whitespace pieces, SentencePiece-style.
        text = " ".join(text.split())
        return _WS + text.replace(" ", _WS)

    def encode(self, text: str) -> list[int]:
        """Viterbi best segmentation -> ids (in C++ when built)."""
        s = self._normalize(text)
        if self._native is not None:
            lib, handle = self._native
            raw = s.encode("utf-8")
            max_out = len(raw) + 8
            out = (ctypes.c_int32 * max_out)()
            n = lib.rnnt_tok_encode(handle, raw, len(raw), out, max_out)
            if n >= 0:
                return self._fuse_unk(list(out[:n]))
        return self._fuse_unk(self._encode_py(s))

    def _fuse_unk(self, ids: list[int]) -> list[int]:
        """SentencePiece merges runs of adjacent unknown characters into
        ONE <unk> token."""
        out: list[int] = []
        for i in ids:
            if out and i == self.unk_id and out[-1] == self.unk_id:
                continue
            out.append(i)
        return out

    def _encode_py(self, s: str) -> list[int]:
        n = len(s)
        best = [float("-inf")] * (n + 1)
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            # Known pieces starting at i.
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                hit = self._seg.get(s[i:j])
                if hit is not None:
                    pid, score = hit
                    cand = best[i] + score
                    if cand > best[j]:
                        best[j] = cand
                        back[j] = (i, pid)
            # Unknown single character fallback.
            cand = best[i] + self._unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, self.unk_id)
        ids: list[int] = []
        pos = n
        while pos > 0:
            i, pid = back[pos]
            ids.append(pid)
            pos = i
        ids.reverse()
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.id_to_piece[int(i)] for i in ids
                       if 0 <= int(i) < len(self.id_to_piece)
                       and self.pieces[int(i)][2] not in (_CONTROL, _UNKNOWN))
        return text.replace(_WS, " ").lstrip(" ")

    def piece_table(self) -> dict[int, str]:
        """id -> piece table (the ``vocab_json`` format)."""
        return dict(enumerate(self.id_to_piece))
