"""``smith_waterman`` CLI — byte-compatible with the reference
``bin/smith_waterman`` (tools/sw_cmdline.c).  The Perl wrapper
(perl/SmithWaterman.pm) drives the interactive keystroke protocol, so the
exact prompt/format is a public API.
"""

from __future__ import annotations

import sys

from ..aligners import SmithWaterman
from ..scoring.config import ScoringConfig, UnknownCharPair
from ..io.seqio import align_from_file
from ._common import (
    COL_CONTEXT,
    COL_STOP,
    SW_CMD,
    ResumeState,
    arm_watchdog,
    alignment_spacer,
    cli_device,
    colour_print_against,
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
    # SW defaults differ from the library default: match 2, mismatch -2,
    # gap_open -2, gap_extend -1 (tools/sw_cmdline.c:37-46)
    sc = ScoringConfig(2, -2, -2, -1)
    cmd, sc = parse_args(argv, sc, SW_CMD)
    out = sys.stdout
    stats = make_stats()
    resume = ResumeState()
    # resumed runs continue the reference's global alignment counter so the
    # concatenated output is identical to one uninterrupted run (restored
    # from the offset file's second field — empty-seq pairs don't consume
    # an index, sw_cmdline.c:136-150)
    state = {"alignment_index": resume.initial_index,
             "wait_on_keystroke": False}

    def get_next_hit():
        # interactive h/a prompt (tools/sw_cmdline.c:84-122)
        if not state["wait_on_keystroke"]:
            return True
        while True:
            out.write("next [h]it or [a]lignment: ")
            out.flush()
            response = None
            while True:
                ch = sys.stdin.read(1)
                if ch == "" or ch is None:
                    out.write("\n")
                    sys.exit(0)
                if ch in ("\n", "\r"):
                    break
                if ch in "hH":
                    response = True
                elif ch in "aA":
                    response = False
            if response is not None:
                return response

    def print_alignment_part(seq1, seq2, pos, length, context_str,
                             spaces_left, spaces_right, context_left,
                             context_right):
        # tools/sw_cmdline.c:49-82
        out.write("  ")
        out.write(" " * spaces_left)
        if context_left > 0:
            if cmd.print_colour:
                out.write(COL_CONTEXT)
            out.write(context_str[pos - context_left:pos])
            if cmd.print_colour:
                out.write(COL_STOP)
        if cmd.print_colour:
            out.write(colour_print_against(seq1, seq2, sc.case_sensitive))
        else:
            out.write(seq1)
        if context_right > 0:
            if cmd.print_colour:
                out.write(COL_CONTEXT)
            out.write(context_str[pos + length:pos + length + context_right])
            if cmd.print_colour:
                out.write(COL_STOP)
        out.write(" " * spaces_right)
        out.write("  [pos: %li; len: %lu]\n" % (pos, length))

    sw = SmithWaterman(sc, device=cli_device())

    def default_min_score(len_a, len_b):
        """The default limit formula, with the C double expression's int
        truncation (tools/sw_cmdline.c:192-202).  ONE definition: the
        pruning hint and the break threshold must stay exactly equal or
        device-pruned candidates could drop hits the reference prints."""
        return int(sc.match * max(0.2 * min(len_a, len_b), 2))

    def prune_for(len_a, len_b):
        """The run's min-score break threshold, passed to the aligner as a
        candidate-pruning hint so big fills harvest candidates on device.
        Disabled in interactive mode (min_score 0) and in ref-mask-compat
        mode (sub-threshold walks must still mark the shared mask exactly
        like the reference)."""
        if sw.history is not None or state["wait_on_keystroke"]:
            return None
        if cmd.min_score_set:
            return cmd.min_score
        return default_min_score(len_a, len_b)

    def align(seq_a, seq_b, name_a=None, name_b=None, hits=None):
        # tools/sw_cmdline.c:125-311
        if (name_a is not None or name_b is not None) and \
                state["wait_on_keystroke"]:
            sys.stderr.write(
                "Error: Interactive input takes seq only (no FASTA/FASTQ)"
                " '%s:%s'\n" % (name_a, name_b)
            )
            sys.stderr.flush()
            sys.exit(1)

        if seq_a == "" or seq_b == "":
            sys.stderr.write("Error: Sequences must have length > 0\n")
            sys.stderr.flush()
            if cmd.print_fasta and name_a is not None and name_b is not None:
                sys.stderr.write("%s\n%s\n" % (name_a, name_b))
            sys.stderr.flush()
            return

        mats = None
        if hits is None:
            with stats_timer(stats, [len(seq_a)], [len(seq_b)]):
                if cmd.print_matrices:
                    # one fill serves both the dump and the hit iterator
                    hits, mats = sw.align_with_matrices(seq_a, seq_b)
                else:
                    hits = sw.align(seq_a, seq_b,
                                    min_score=prune_for(len(seq_a),
                                                        len(seq_b)))
        len_a, len_b = len(seq_a), len(seq_b)

        out.write("== Alignment %zu lengths (%lu, %lu):\n".replace(
            "%zu", "%i").replace("%lu", "%i")
            % (state["alignment_index"], len_a, len_b))

        if cmd.print_matrices:
            if mats is None:
                mats = sw.matrices(seq_a, seq_b)
            out.write(print_matrices_str(*mats, seq_a, seq_b, sc))

        if cmd.print_fasta and name_a is not None:
            out.write(name_a + "\n")
        if cmd.print_seq:
            out.write(seq_a + "\n")
        if cmd.print_fasta and name_b is not None:
            out.write(name_b + "\n")
        if cmd.print_seq:
            out.write(seq_b + "\n")
        out.write("\n")

        min_score = cmd.min_score
        if not cmd.min_score_set:
            min_score = 0 if state["wait_on_keystroke"] else \
                default_min_score(len_a, len_b)
        out.flush()

        hit_index = 0
        while True:
            if not get_next_hit():
                break
            r = hits.fetch()
            if r is None or r.score < min_score:
                break
            if cmd.max_hits_per_alignment_set and \
                    hit_index >= cmd.max_hits_per_alignment:
                break
            out.write("hit %i.%i score: %i\n"
                      % (state["alignment_index"], hit_index, r.score))
            hit_index += 1

            context_left = context_right = 0
            left_spaces_a = left_spaces_b = 0
            right_spaces_a = right_spaces_b = 0
            if cmd.print_context:
                context_left = min(max(r.pos_a, r.pos_b), cmd.print_context)
                rem_a = len_a - (r.pos_a + r.len_a)
                rem_b = len_b - (r.pos_b + r.len_b)
                context_right = min(max(rem_a, rem_b), cmd.print_context)
                left_spaces_a = max(context_left - r.pos_a, 0)
                left_spaces_b = max(context_left - r.pos_b, 0)
                right_spaces_a = max(context_right - rem_a, 0)
                right_spaces_b = max(context_right - rem_b, 0)

            print_alignment_part(
                r.result_a, r.result_b, r.pos_a, r.len_a, seq_a,
                left_spaces_a, right_spaces_a,
                context_left - left_spaces_a, context_right - right_spaces_a,
            )
            if cmd.print_pretty:
                out.write("  ")
                max_left = max(left_spaces_a, left_spaces_b)
                max_right = max(right_spaces_a, right_spaces_b)
                out.write(" " * max_left)
                out.write("." * (context_left - max_left))
                out.write(alignment_spacer(r.result_a, r.result_b, sc))
                out.write("." * (context_right - max_right))
                out.write(" " * max_right)
                out.write("\n")
            print_alignment_part(
                r.result_b, r.result_a, r.pos_b, r.len_b, seq_b,
                left_spaces_b, right_spaces_b,
                context_left - left_spaces_b, context_right - right_spaces_b,
            )
            out.write("\n")
            out.flush()

        out.write("==\n")
        out.flush()
        state["alignment_index"] += 1

    def align_many(pairs):
        """One batched device fill per chunk of file pairs (the reference
        aligns serially, alignment_cmdline.c:611-622)."""
        todo = [i for i, (r1, r2) in enumerate(pairs) if r1[1] and r2[1]]
        mins = [prune_for(len(pairs[i][0][1]), len(pairs[i][1][1]))
                for i in todo]
        if any(m is None for m in mins):
            mins = None
        try:
            with stats_timer(stats, [len(pairs[i][0][1]) for i in todo],
                             [len(pairs[i][1][1]) for i in todo]):
                iters = sw.align_batch([pairs[i][0][1] for i in todo],
                                       [pairs[i][1][1] for i in todo],
                                       min_scores=mins) \
                    if todo else []
        except UnknownCharPair:
            # an invalid pair mid-chunk: align pair-by-pair so the pairs
            # the reference already printed are printed before the error
            # aborts (alignment_scoring.c:177-182)
            for r1, r2 in pairs:
                align(r1[1], r2[1], r1[0], r2[0])
            return
        by_pair = dict(zip(todo, iters))
        for i, (r1, r2) in enumerate(pairs):
            align(r1[1], r2[1], r1[0], r2[0], hits=by_pair.get(i))

    try:
        with trace_context():
            _sw_run(cmd, align, align_many, resume, state)
    except UnknownCharPair as e:
        # alignment_scoring.c:177-182: 'Error: <msg>' on stderr, exit 1
        sys.stderr.write("Error: %s\n" % e)
        disarm()
        return 1
    stats_finish(stats)
    disarm()
    return 0


def _sw_run(cmd, align, align_many, resume, state):
    if cmd.seq1 is not None:
        align(cmd.seq1, cmd.seq2)

    CHUNK = 256
    for file1, file2 in cmd.file_pairs:
        streaming = cmd.interactive or file1 in ("", "-")
        if file1 == "" and file2 is None:
            state["wait_on_keystroke"] = True
            file1 = "-"
        if streaming:
            def one(r1, r2):
                if resume.should_skip():
                    return
                align(r1[1], r2[1], r1[0], r2[0])
                resume.done(1, state["alignment_index"])

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
                    resume.done(len(buf), state["alignment_index"])
                    del buf[:]

            def flush(buf=buf):
                # drained at the reader's end-of-input point so a fatal
                # alignment error pre-empts the EOF warnings like the
                # reference (see io.seqio.align_from_file)
                if buf:
                    align_many(buf)
                    resume.done(len(buf), state["alignment_index"])
                    del buf[:]

            align_from_file(file1, file2, collect, use_zlib=True,
                            flush=flush)


if __name__ == "__main__":
    sys.exit(main())
