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
"""

from .aligners import NeedlemanWunsch, SmithWaterman, lcs_aligner, lcs_hits
from .ops.kernels import kernel_launch_counts, reset_kernel_launch_counts
from .ops.pack import kernel_params
from .scoring import presets
from .scoring.config import ScoringConfig, from_reference

__all__ = ["NeedlemanWunsch", "ScoringConfig", "SmithWaterman",
           "from_reference", "kernel_launch_counts", "kernel_params",
           "lcs_aligner", "lcs_hits", "presets",
           "reset_kernel_launch_counts"]
