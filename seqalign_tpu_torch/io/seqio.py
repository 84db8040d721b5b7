"""Streaming sequence reader — the framework's equivalent of the bundled
``seq_file`` submodule (reference L1a; API known from call sites in
alignment_cmdline.c:570-640; format surface per reference README.md:28:
FASTA, FASTQ, plain, SAM, BAM, with transparent gzip).

Yields (name, sequence) records; plain lines have name None (matching
``read->name.end == 0`` => NULL name in the reference CLI glue,
nw_cmdline.c:151-156).  SAM/BAM records yield (QNAME, SEQ) with SEQ as
stored in the record ('*' => empty string); BAM is BGZF, i.e. concatenated
gzip members, which ``gzip.GzipFile`` decodes natively.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
import sys
from typing import Iterator, Optional, Tuple

Record = Tuple[Optional[str], str]

_SAM_HEADER_CODES = ("@HD", "@SQ", "@RG", "@PG", "@CO")
# BAM 4-bit base codes (SAM spec §4.2.3)
_BAM_BASES = "=ACMGRSVTWYHKDBN"


def _open_binary(path: str):
    """Open a decompressed *binary* stream with ``peek`` support ('-' =
    stdin; gzip/BGZF sniffed by magic bytes, like seq_open)."""
    if path == "-":
        raw = sys.stdin.buffer
    else:
        raw = open(path, "rb")
    head = raw.peek(2)[:2] if hasattr(raw, "peek") else b""
    if head == b"\x1f\x8b":
        return gzip.GzipFile(fileobj=raw)
    return raw


def _is_sam_first_line(line: str) -> bool:
    """Sniff SAM from the first non-empty line: a header tag, or a headerless
    alignment line (>= 11 tab fields with numeric FLAG/POS/MAPQ — FASTA/Q
    and plain-line inputs never contain tabs)."""
    if line[:3] in _SAM_HEADER_CODES and (len(line) == 3 or line[3] == "\t"):
        return True
    if line.startswith(">") or line.startswith("@"):
        return False
    f = line.split("\t")
    return (len(f) >= 11 and f[1].isdigit() and f[3].isdigit()
            and f[4].isdigit())


def _sam_records(first_line: str, getline) -> Iterator[Record]:
    line: Optional[str] = first_line
    while line is not None:
        if line and not line.startswith("@"):
            f = line.split("\t")
            if len(f) >= 11:
                yield (f[0], "" if f[9] == "*" else f[9])
        nxt = getline()
        line = nxt.rstrip("\r\n") if nxt else None


def _read_bam(raw) -> Iterator[Record]:
    """Parse BAM alignment records (SAM spec §4.2) from a decompressed
    binary stream positioned at the ``BAM\\1`` magic."""
    def rd(n: int) -> bytes:
        b = raw.read(n)
        if len(b) < n:
            raise EOFError("truncated BAM")
        return b

    if rd(4) != b"BAM\x01":
        raise ValueError("not a BAM stream")
    (l_text,) = struct.unpack("<i", rd(4))
    rd(l_text)  # header text
    (n_ref,) = struct.unpack("<i", rd(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", rd(4))
        rd(l_name + 4)  # name + l_ref
    while True:
        b4 = raw.read(4)
        if len(b4) < 4:
            return
        (block_size,) = struct.unpack("<i", b4)
        rec = rd(block_size)
        l_read_name = rec[8]
        (n_cigar_op,) = struct.unpack("<H", rec[12:14])
        (l_seq,) = struct.unpack("<i", rec[16:20])
        off = 32
        name = rec[off:off + l_read_name - 1].decode("latin-1")
        off += l_read_name + 4 * n_cigar_op
        sb = rec[off:off + (l_seq + 1) // 2]
        seq = []
        for i in range(l_seq):
            b = sb[i >> 1]
            seq.append(_BAM_BASES[(b >> 4) if (i & 1) == 0 else (b & 0xF)])
        yield (name, "".join(seq))


def _records_from_text(fh) -> Iterator[Record]:
    """FASTA / FASTQ / plain / SAM records from a text stream."""
    pushback: Optional[str] = None

    def getline():
        nonlocal pushback
        if pushback is not None:
            ln, pushback = pushback, None
            return ln
        return fh.readline()

    first = True
    while True:
        line = getline()
        if not line:
            return
        line = line.rstrip("\r\n")
        if line == "":
            continue
        if first and _is_sam_first_line(line):
            yield from _sam_records(line, getline)
            return
        first = False
        if line.startswith(">"):
            # FASTA: sequence continues until next header/@/EOF
            name = line[1:]
            seq_parts = []
            while True:
                nxt = fh.readline()
                if not nxt:
                    break
                if nxt.startswith(">") or nxt.startswith("@"):
                    pushback = nxt
                    break
                seq_parts.append(nxt.strip())
            yield (name, "".join(seq_parts))
        elif line.startswith("@"):
            # FASTQ: 4-line record
            name = line[1:]
            seq = (fh.readline() or "").rstrip("\r\n")
            plus = fh.readline()  # '+' line
            _qual = fh.readline()
            del plus, _qual
            yield (name, seq)
        else:
            # plain sequence line
            yield (None, line)


def read_seqs(path_or_fh, use_zlib: bool = True) -> Iterator[Record]:
    """Yield (name | None, seq) from FASTA/FASTQ/plain/SAM/BAM input."""
    if hasattr(path_or_fh, "read"):
        return _records_from_text(path_or_fh)
    if path_or_fh == "-" and (
        not use_zlib or not hasattr(sys.stdin, "buffer")
    ):
        # interactive mode shares sys.stdin with the h/a keystroke prompt
        # (sw_cmdline.c:84-122) — never re-wrap/buffer it
        return _records_from_text(sys.stdin)
    raw = _open_binary(path_or_fh)
    head = raw.peek(4)[:4] if hasattr(raw, "peek") else b""
    if head == b"BAM\x01":
        return _read_bam(raw)
    return _records_from_text(io.TextIOWrapper(raw, encoding="latin-1"))


def align_from_file(path1: str, path2: Optional[str], callback,
                    use_zlib: bool = True, flush=None) -> None:
    """Pair-streaming driver mirroring ``align_from_file``
    (alignment_cmdline.c:578-640): one file => two records at a time;
    two files => one record from each.  Warnings byte-match the reference.

    ``flush`` is called before any end-of-input warning: the reference
    aligns DURING reading, so a fatal alignment error (e.g. unknown char
    pair) pre-empts the odd-count/empty warnings — a chunk-buffering
    caller must drain its buffer at the same point to keep stderr
    ordering byte-identical."""
    def _open_records(path):
        if path != "-" and use_zlib:
            from . import native

            if native.available():
                if not os.path.exists(path):
                    raise OSError(path)
                return native.read_seqs_native(path)
        return read_seqs(path, use_zlib)

    try:
        s1 = _open_records(path1)
    except OSError:
        sys.stderr.write("Alignment Error: couldn't open file %s\n" % path1)
        sys.stderr.flush()
        return
    if path2 is None:
        s2 = s1
    else:
        try:
            s2 = _open_records(path2)
        except OSError:
            # (the reference prints path1 here too — bug-compatible,
            # alignment_cmdline.c:598)
            sys.stderr.write("Alignment Error: couldn't open file %s\n" % path1)
            sys.stderr.flush()
            return

    alignments = 0
    for r1 in s1:
        r2 = next(s2, None)
        if r2 is None:
            if flush is not None:
                flush()
            sys.stderr.write(
                "Alignment Error: Odd number of sequences - I read in pairs!\n"
            )
            sys.stderr.flush()
            break
        callback(r1, r2)
        alignments += 1
    else:
        if flush is not None:
            flush()
    if alignments == 0:
        sys.stderr.write("Alignment Warning: empty input\n")
        sys.stderr.flush()


def read_seqs_sharded(path: str, shard_index: int, num_shards: int,
                      use_zlib: bool = True) -> Iterator[Record]:
    """Round-robin record sharding for multi-host input streaming (each host
    reads every num_shards-th record; SURVEY §2.4 distributed input).  For
    pair-per-two-records files, shard by PAIR so hosts get whole pairs."""
    it = read_seqs(path, use_zlib)
    pair_idx = 0
    while True:
        r1 = next(it, None)
        if r1 is None:
            return
        r2 = next(it, None)
        if pair_idx % num_shards == shard_index:
            yield r1
            if r2 is not None:
                yield r2
        if r2 is None:
            return
        pair_idx += 1


def read_pairs(path1: str, path2: Optional[str] = None,
               use_zlib: bool = True) -> Iterator[tuple]:
    """Yield (pair_index, record1, record2) with the same pairing rule as
    ``align_from_file`` (alignment_cmdline.c:578-640): one file => two
    consecutive records per pair; two files => one record from each.
    An unpaired trailing record is dropped (the CLI layer warns)."""
    s1 = read_seqs(path1, use_zlib)
    s2 = s1 if path2 is None else read_seqs(path2, use_zlib)
    idx = 0
    for r1 in s1:
        r2 = next(s2, None)
        if r2 is None:
            return
        yield idx, r1, r2
        idx += 1


def read_pairs_sharded(path1: str, path2: Optional[str], shard_index: int,
                       num_shards: int, use_zlib: bool = True):
    """Round-robin PAIR sharding across hosts: host k processes pairs
    k, k+n, k+2n, ... — the multi-host input path (SURVEY §2.4-3); global
    pair indices are preserved so results can be re-assembled in order."""
    if path2 is None:
        it = read_seqs_sharded(path1, shard_index, num_shards, use_zlib)
        j = 0
        while True:
            r1 = next(it, None)
            if r1 is None:
                return
            r2 = next(it, None)
            if r2 is None:
                return
            yield shard_index + j * num_shards, r1, r2
            j += 1
    else:
        s1 = read_seqs(path1, use_zlib)
        s2 = read_seqs(path2, use_zlib)
        idx = 0
        for r1 in s1:
            r2 = next(s2, None)
            if r2 is None:
                return
            if idx % num_shards == shard_index:
                yield idx, r1, r2
            idx += 1
