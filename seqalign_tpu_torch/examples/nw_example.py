#!/usr/bin/env python3
"""Library embedding example of the port, the counterpart of
examples/nw_example.py (the reference's examples/nw_example.c): custom
scoring with asymmetric substitution costs (scoring_add_mutation,
nw_example.c:44-51).  It aligns on the device ``SEQALIGN_DEVICE`` names,
as the CLIs do: ``cuda`` (the default) or ``cpu``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from seqalign_tpu_torch import NeedlemanWunsch, ScoringConfig  # noqa: E402
from seqalign_tpu_torch.cli._common import cli_device  # noqa: E402

# match/mismatch/gap_open/gap_extend + flags
sc = ScoringConfig(1, -2, -4, -1, case_sensitive=True)
# asymmetric substitution costs: T->C cheap, C->T expensive
sc.add_mutation("t", "c", -1)
sc.add_mutation("c", "t", -3)

nw = NeedlemanWunsch(sc, device=cli_device())
result = nw.align("atcgtagc", "ctcgtaac")
print(result.result_a)
print(result.result_b)
print("score:", result.score)

# batched alignment: many pairs in one call
pairs_a = ["acgtacgt", "tttgggcc", "gattaca"]
pairs_b = ["acgaacgt", "ttgggcct", "gtcgacga"]
for aln in nw.align_batch(pairs_a, pairs_b):
    print(aln.result_a, aln.result_b, aln.score)
