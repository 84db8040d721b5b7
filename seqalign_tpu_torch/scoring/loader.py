"""Substitution-score file loaders — the TPU framework's equivalent of
``alignment_scoring_load.c`` (reference C5).

Two formats, both gzip-transparent (the reference reads via zlib ``gzFile``,
alignment_scoring_load.c:39-47):

* **matrix** (``align_scoring_load_matrix``, alignment_scoring_load.c:39-220):
  first non-comment line is the column-header characters; the separator is
  inferred from its first character — whitespace => whitespace-split parsing,
  anything else => that single character separates fields.  ``#`` lines are
  comments.  Each row: row-char then one score per column char.
* **pairwise** (``align_scoring_load_pairwise``, alignment_scoring_load.c:
  223-306): lines of ``a b score``; errors if zero pairs were loaded
  (alignment_scoring_load.c:301-305).

Characters are folded to lowercase when the config is case-insensitive,
exactly as the reference folds during load (alignment_scoring_load.c:91,107,
159,170,286-290).
"""

from __future__ import annotations

import gzip
import io
from typing import Union

from .config import ScoringConfig


def _make_fold(sc: ScoringConfig, case_sensitive):
    """Fold chars per the given case flag (default: the config's flag)."""
    cs = sc.case_sensitive if case_sensitive is None else case_sensitive
    if cs:
        return lambda c: int(c)
    return lambda c: int(c) + 32 if 65 <= int(c) <= 90 else int(c)


class ScoringLoadError(ValueError):
    """Parse failure; message mirrors the reference's loading_error intent."""


def _open_text(path_or_file) -> io.TextIOBase:
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
        if isinstance(data, bytes):
            return io.StringIO(data.decode("latin-1"))
        return io.StringIO(data)
    with open(path_or_file, "rb") as fh:
        head = fh.read(2)
    if head == b"\x1f\x8b":
        with gzip.open(path_or_file, "rb") as gz:
            return io.StringIO(gz.read().decode("latin-1"))
    with open(path_or_file, "rb") as fh:
        return io.StringIO(fh.read().decode("latin-1"))


def load_matrix(path_or_file, sc: ScoringConfig,
                use_match_mismatch: bool = False,
                case_sensitive=None) -> ScoringConfig:
    """Parse an NCBI-style matrix file into ``sc`` (scoring_add_mutation per
    cell).  Mirrors align_scoring_load_matrix semantics; ``use_match_mismatch``
    keeps the match/mismatch fallback active alongside the table (the CLI sets
    this when --match/--mismatch were given explicitly,
    alignment_cmdline.c:492-496).  ``case_sensitive`` overrides the fold
    behavior (the CLI passes cmd->case_sensitive, which is independent of
    scoring_t.case_sensitive — alignment_cmdline.c:347)."""
    fold = _make_fold(sc, case_sensitive)
    fh = _open_text(path_or_file)
    lines = [ln.rstrip("\r\n") for ln in fh]

    # first non-empty, non-comment, non-whitespace line = column headings
    idx = 0
    header = None
    while idx < len(lines):
        ln = lines[idx]
        idx += 1
        if ln and ln[0] != "#" and ln.strip() != "":
            header = ln
            break
    if header is None:
        raise ScoringLoadError("Empty file")
    if len(header) < 2:
        raise ScoringLoadError("Too few column headings")

    sep = header[0]
    if sep.isdigit() or sep == "-":
        raise ScoringLoadError(
            "Numbers (0-9) and dashes (-) do not make good separators"
        )

    if sep.isspace():
        # whitespace branch: every non-whitespace CHAR after position 0 is a
        # column char (alignment_scoring_load.c:85-92)
        col_chars = [fold(ord(c)) for c in header[1:] if not c.isspace()]
        for ln in lines[idx:]:
            if ln.strip() == "" or (ln and ln[0] == "#"):
                continue
            stripped = ln.lstrip()
            row = fold(ord(stripped[0]))
            # scores start scanning right after position 1 (c:110-139)
            toks = ln[1:].split()
            # first token is the rest of... the reference requires the row
            # char at position 0; valid NCBI files satisfy this, so toks are
            # exactly the scores
            if len(toks) < len(col_chars):
                raise ScoringLoadError("Missing number value on line")
            if len(toks) > len(col_chars):
                raise ScoringLoadError("Too many columns on row")
            for cchar, stok in zip(col_chars, toks):
                sc.add_mutation(row, cchar, _parse_int(stok))
        nloaded = True
    else:
        # single-char separator branch (c:148-216).  Header: sep at even
        # positions, chars at odd.  Rows (bug-compatible): position 0 must be
        # the separator and IS taken as the row char.
        col_chars = []
        i = 0
        while i < len(header):
            if header[i] != sep:
                raise ScoringLoadError("Separator missing from line")
            if i + 1 < len(header):
                col_chars.append(fold(ord(header[i + 1])))
            i += 2
        for ln in lines[idx:]:
            if ln.strip() == "" or (ln and fold(ord(ln[0])) == ord("#")):
                continue
            row = fold(ord(ln[0]))  # == sep (reference c:166 quirk)
            pos = 0
            ci = 0
            while pos < len(ln):
                if ln[pos] != sep:
                    raise ScoringLoadError("Separator missing from line")
                pos += 1
                j = pos
                if j < len(ln) and ln[j] in "+-":
                    j += 1
                while j < len(ln) and ln[j].isdigit():
                    j += 1
                if j == pos or ln[pos:j] in ("+", "-"):
                    raise ScoringLoadError("Missing number value on line")
                if ci >= len(col_chars):
                    raise ScoringLoadError("Too many columns on row")
                sc.add_mutation(row, col_chars[ci], int(ln[pos:j]))
                ci += 1
                pos = j
        nloaded = True

    sc.use_match_mismatch = use_match_mismatch
    sc._luts = None
    return sc


def load_pairwise(path_or_file, sc: ScoringConfig,
                  use_match_mismatch: bool = False,
                  case_sensitive=None) -> ScoringConfig:
    """Parse ``a b score`` lines (align_scoring_load_pairwise)."""
    fold = _make_fold(sc, case_sensitive)
    fh = _open_text(path_or_file)
    npairs = 0
    for raw in fh:
        line = raw.rstrip("\r\n")
        if not line or line[0] == "#" or line.strip() == "":
            continue
        # per-line positional parse (alignment_scoring_load.c:242-283)
        if len(raw.rstrip("\n")) + 1 < 5:  # read_length incl newline < 5
            raise ScoringLoadError("Too few column headings")
        if line[1].isspace():
            a = line[0]
            i = 1
            while i < len(line) and line[i].isspace():
                i += 1
            if i + 2 >= len(line) + 1 or i + 1 >= len(line) or \
                    not line[i + 1].isspace():
                raise ScoringLoadError("Line too short")
            b = line[i]
            score = _parse_int(line[i + 2:].strip())
        else:
            if len(line) < 5 or line[1] != line[3]:
                raise ScoringLoadError("Inconsistent separators used")
            a, b = line[0], line[2]
            score = _parse_int(line[4:])
        sc.add_mutation(fold(ord(a)), fold(ord(b)), score)
        npairs += 1
    if npairs == 0:
        # alignment_scoring_load.c:301-305
        raise ScoringLoadError("No substitution scores in pairwise file")
    sc.use_match_mismatch = use_match_mismatch
    sc._luts = None
    return sc


def _parse_int(tok: str) -> int:
    """Strict integer parse (parse_entire_int, alignment_cmdline.c:32-47)."""
    try:
        return int(tok, 10)
    except ValueError:
        raise ScoringLoadError(f"Invalid score integer {tok!r}") from None
