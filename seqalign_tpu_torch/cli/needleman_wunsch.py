"""``needleman_wunsch`` CLI — byte-compatible with the reference
``bin/needleman_wunsch`` (tools/nw_cmdline.c).  The Perl wrapper
(perl/NeedlemanWunsch.pm) screen-scrapes this format, so it is a public API.
"""

from __future__ import annotations

import os
import sys

from ..aligners import NeedlemanWunsch
from ..io.seqio import align_from_file
from ..ops.oracle import TracebackFail
from ..scoring.config import UnknownCharPair
from ..scoring.presets import scoring_system_default
from ._common import (
    NW_CMD,
    ResumeState,
    arm_watchdog,
    alignment_spacer,
    cli_device,
    colour_print_against,
    fold_eq,
    make_stats,
    parse_args,
    print_matrices_str,
    stats_finish,
    stats_timer,
    trace_context,
)


def main(argv=None):
    argv = list(sys.argv) if argv is None else list(argv)
    disarm = arm_watchdog()
    sc = scoring_system_default()
    cmd, sc = parse_args(argv, sc, NW_CMD)
    aligner = NeedlemanWunsch(sc, device=cli_device())
    out = sys.stdout
    stats = make_stats()
    resume = ResumeState()

    def align_zam(seq_a, seq_b):
        # tools/nw_cmdline.c:36-76
        r = aligner.align(seq_a, seq_b)
        ra = r.result_a.replace("-", "_")
        rb = r.result_b.replace("-", "_")
        mismatches = indels = 0
        spacer = []
        for ca, cb in zip(ra, rb):
            if ca == "_" or cb == "_":
                spacer.append(" ")
                indels += 1
            elif (sc.case_sensitive and ca != cb) or \
                    ca.lower() != cb.lower():
                spacer.append("*")
                mismatches += 1
            else:
                spacer.append("|")
        out.write("Br1:%s\n    %s\nBr2:%s\n%i %i\n\n"
                  % (ra, "".join(spacer), rb, mismatches, indels))
        out.flush()

    def align(seq_a, seq_b, name_a=None, name_b=None):
        # tools/nw_cmdline.c:78-149
        if cmd.zam_stle_output:
            with stats_timer(stats, [len(seq_a)], [len(seq_b)]):
                align_zam(seq_a, seq_b)
            return
        with stats_timer(stats, [len(seq_a)], [len(seq_b)]):
            if cmd.print_matrices:
                # one fill serves both the matrix dump and the traceback (the
                # reference prints from live fill state, tools/nw_cmdline.c:107)
                r, (M, Ga, Gb) = aligner.align_with_matrices(seq_a, seq_b)
                out.write(print_matrices_str(M, Ga, Gb, seq_a, seq_b, sc))
            else:
                r = aligner.align(seq_a, seq_b)
        _print_alignment(r, name_a, name_b)

    def align_many(pairs):
        """Batched fill for a chunk of (r1, r2) records — one device program
        per chunk instead of per pair (the reference aligns serially,
        alignment_cmdline.c:611-622)."""
        if cmd.zam_stle_output or cmd.print_matrices \
                or os.environ.get("SEQALIGN_REF_WRAP") == "1":
            # REF_WRAP must align+print pair-by-pair like the reference:
            # a wrap abort mid-chunk would otherwise drop the completed
            # pairs' output that the reference already printed
            for r1, r2 in pairs:
                align(r1[1], r2[1], r1[0], r2[0])
            return
        try:
            with stats_timer(stats, [len(r1[1]) for r1, _ in pairs],
                             [len(r2[1]) for _, r2 in pairs]):
                results = aligner.align_batch([r1[1] for r1, _ in pairs],
                                              [r2[1] for _, r2 in pairs])
        except UnknownCharPair:
            # an invalid pair mid-chunk: align pair-by-pair so the pairs
            # the reference already printed are printed before the error
            # aborts (alignment_scoring.c:177-182)
            for r1, r2 in pairs:
                align(r1[1], r2[1], r1[0], r2[0])
            return
        for (r1, r2), r in zip(pairs, results):
            _print_alignment(r, r1[0], r2[0])

    def _print_alignment(r, name_a, name_b):
        if cmd.print_fasta and name_a is not None:
            out.write(name_a + "\n")
        if cmd.print_fasta and cmd.print_pretty and name_b is not None:
            out.write(name_b + "\n")
        if cmd.print_colour:
            out.write(colour_print_against(r.result_a, r.result_b,
                                           sc.case_sensitive))
        else:
            out.write(r.result_a)
        out.write("\n")
        if cmd.print_pretty:
            out.write(alignment_spacer(r.result_a, r.result_b, sc))
            out.write("\n")
        elif cmd.print_fasta and name_b is not None:
            out.write(name_b + "\n")
        if cmd.print_colour:
            out.write(colour_print_against(r.result_b, r.result_a,
                                           sc.case_sensitive))
        else:
            out.write(r.result_b)
        out.write("\n")
        if cmd.print_scores:
            out.write("score: %i\n" % r.score)
        out.write("\n")
        out.flush()

    try:
        with trace_context():
            _run_alignments(cmd, align, align_many, resume)
    except UnknownCharPair as e:
        # alignment_scoring.c:177-182: 'Error: <msg>' on stderr, exit 1
        sys.stderr.write("Error: %s\n" % e)
        disarm()
        return 1
    except TracebackFail as tf:
        if not hasattr(tf, "matrices"):
            # not the REF_WRAP path (oracle.reverse_move also serves the
            # normal host traceback): a genuine internal failure — keep
            # the full diagnostic instead of the bug-compat dump
            raise
        # SEQALIGN_REF_WRAP=1 bug-compat: reproduce the reference's abort
        # byte-for-byte — matrices to stdout, diagnostics to stderr, exit 1
        # (alignment.c:329-349)
        out.write(print_matrices_str(*tf.matrices, tf.seq_a, tf.seq_b, sc))
        out.flush()
        sys.stderr.write(
            "[%s:%d,%d]: %d [ismatch: %d] '%s' '%s'\n"
            % (tf.matrix_name, tf.x, tf.y, tf.score, tf.is_match, tf.ca,
               tf.cb))
        sys.stderr.write(" Penalties match: %d gap_open: %d gap_extend:"
                         " %d\n" % (tf.pm, tf.pga, tf.pgb))
        sys.stderr.write(" Expected MATCH: %d GAP_A: %d GAP_B: %d\n"
                         % (tf.em, tf.ega, tf.egb))
        sys.stderr.write(
            "Program error: traceback fail (get_reverse_move)\n"
            "This may be due to an integer overflow if your sequences are"
            " long or scores\n"
            "are large. If this is the case using smaller scores or"
            " shorter sequences may\n"
            "work around this problem.  \n"
            "  If you think this is a bug, please report it to:"
            " turner.isaac@gmail.com\n")
        disarm()
        return 1
    stats_finish(stats)
    disarm()
    return 0


def _run_alignments(cmd, align, align_many, resume):
    if cmd.seq1 is not None:
        align(cmd.seq1, cmd.seq2)

    CHUNK = 256
    for file1, file2 in cmd.file_pairs:
        streaming = cmd.interactive or file1 in ("", "-")
        if file1 == "" and file2 is None:
            file1 = "-"
        if streaming:
            # stdin follows the immediate-response protocol the Perl
            # wrapper depends on (NeedlemanWunsch.pm:182-211) — align
            # pair by pair
            def one(r1, r2):
                if resume.should_skip():
                    return
                align(r1[1], r2[1], r1[0], r2[0])
                resume.done(1)

            align_from_file(file1, file2, one,
                            use_zlib=not cmd.interactive)
        else:
            buf = []

            def collect(r1, r2, buf=buf):
                if resume.should_skip():
                    return
                buf.append((r1, r2))
                if len(buf) >= CHUNK:
                    align_many(buf)
                    resume.done(len(buf))
                    del buf[:]

            def flush(buf=buf):
                # drained at the reader's end-of-input point so a fatal
                # alignment error pre-empts the EOF warnings like the
                # reference (see io.seqio.align_from_file)
                if buf:
                    align_many(buf)
                    resume.done(len(buf))
                    del buf[:]

            align_from_file(file1, file2, collect, use_zlib=True,
                            flush=flush)


if __name__ == "__main__":
    sys.exit(main())
