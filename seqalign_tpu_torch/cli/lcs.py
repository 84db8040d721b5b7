"""``lcs`` CLI — byte-compatible with the reference ``bin/lcs``
(tools/lcs_cmdline.c): longest common substrings of a sequence with itself,
in decreasing length order, printed as ``substring [posA,posB]``."""

from __future__ import annotations

import sys

from ..aligners import lcs_aligner, lcs_hits
from ._common import (arm_watchdog, cli_device, make_stats, stats_finish,
                      stats_timer)


def main(argv=None):
    argv = list(sys.argv) if argv is None else list(argv)
    disarm = arm_watchdog()
    if len(argv) != 2:
        sys.stderr.write("%s [options] <sequence>\n" % argv[0])
        sys.stderr.write("  Print substrings in decreasing order of length\n")
        disarm()
        return 1
    sw = lcs_aligner(case_sensitive=True, device=cli_device())
    stats = make_stats()
    with stats_timer(stats, [len(argv[1])], [len(argv[1])]):
        for hit in lcs_hits(argv[1], sw=sw):
            sys.stdout.write("%s [%i,%i]\n"
                             % (hit.result_a, hit.pos_a, hit.pos_b))
    stats_finish(stats)
    disarm()
    return 0


if __name__ == "__main__":
    sys.exit(main())
