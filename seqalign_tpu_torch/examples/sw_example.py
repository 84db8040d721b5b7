#!/usr/bin/env python3
"""Library embedding example of the port, the counterpart of
examples/sw_example.py (the reference's examples/sw_example.c): the
smith_waterman_fetch hit loop (sw_example.c:56-63).  It aligns on the
device ``SEQALIGN_DEVICE`` names, as the CLIs do: ``cuda`` (the default)
or ``cpu``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from seqalign_tpu_torch import ScoringConfig, SmithWaterman  # noqa: E402
from seqalign_tpu_torch.cli._common import cli_device  # noqa: E402

sc = ScoringConfig(2, -2, -2, -1)
sw = SmithWaterman(sc, device=cli_device())

hits = sw.align("CAGACGTTTACGGACGT", "CGATAACGTTGG")
while True:
    hit = hits.fetch()  # best-first, overlap-masked (smith_waterman.c:260)
    if hit is None or hit.score < 4:
        break
    print(f"score {hit.score}: {hit.result_a} / {hit.result_b} "
          f"@({hit.pos_a},{hit.pos_b})")
