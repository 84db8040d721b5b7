"""seqalign_tpu_torch — the PyTorch/CUDA port of ``seqalign_tpu``.

Batched global (Needleman-Wunsch) and local (Smith-Waterman) scoring and
alignment, with equality or substitution-matrix scoring, on an NVIDIA
Hopper GPU through hand-written CUDA kernels (``csrc/``), with plain
PyTorch versions of the same kernels for CPU tensors.  The package stands
on its own: it keeps its own scoring layer (``scoring/``, with the matrix
files under ``data/scoring``), batch packer (``io/packer.py``,
``native/seqpack.cpp``) and int64 host path (``ops/host_dp.py``,
``ops/oracle.py``), and imports neither JAX nor ``seqalign_tpu``.  A
scoring config of another implementation crosses over through
``scoring.config.from_reference``.

The public names are the JAX package's (``seqalign_tpu/__init__.py``),
plus the port's own: ``lcs_aligner``, ``from_reference``,
``kernel_params``, ``presets`` and the launch counters.  The aligners run
on the GPU unless built with ``device="cpu"``.
"""

__version__ = "1.0.0"  # tracks reference SEQ_ALIGN_VERSION_STR (seq_align.h:12)

from .aligners import NeedlemanWunsch, SmithWaterman, lcs_aligner, lcs_hits
from .ops.host_dp import Alignment
from .ops.kernels import kernel_launch_counts, reset_kernel_launch_counts
from .ops.pack import kernel_params
from .scoring import presets
from .scoring.config import (GAP_A, GAP_B, MATCH, ScoringConfig, encode,
                             from_reference)
from .scoring.loader import load_matrix, load_pairwise
from .scoring.presets import (
    PRESETS,
    scoring_system_BLOSUM62,
    scoring_system_BLOSUM80,
    scoring_system_default,
    scoring_system_DNA_hybridization,
    scoring_system_PAM30,
    scoring_system_PAM70,
    scoring_system_sw_default,
)

__all__ = [
    "Alignment",
    "NeedlemanWunsch",
    "SmithWaterman",
    "lcs_hits",
    "load_matrix",
    "load_pairwise",
    "GAP_A",
    "GAP_B",
    "MATCH",
    "ScoringConfig",
    "encode",
    "PRESETS",
    "scoring_system_BLOSUM62",
    "scoring_system_BLOSUM80",
    "scoring_system_default",
    "scoring_system_DNA_hybridization",
    "scoring_system_PAM30",
    "scoring_system_PAM70",
    "scoring_system_sw_default",
    "__version__",
    # the port's own
    "from_reference",
    "kernel_launch_counts",
    "kernel_params",
    "lcs_aligner",
    "presets",
    "reset_kernel_launch_counts",
]
