"""seqalign_tpu_torch — the PyTorch/CUDA port of ``seqalign_tpu``.

Batched global (Needleman-Wunsch) and local (Smith-Waterman) scoring and
alignment, with equality or substitution-matrix scoring, on an NVIDIA
Hopper GPU through hand-written CUDA kernels (``csrc/``), with plain
PyTorch versions of the same kernels for CPU tensors.  The port shares the
JAX package's jax-free host layers (scoring, packing, host DP) and imports
no JAX; it re-exports the scoring layer (``ScoringConfig`` and the
``presets`` module) so its callers need not import ``seqalign_tpu``.
"""

from seqalign_tpu.scoring import presets
from seqalign_tpu.scoring.config import ScoringConfig

from .aligners import NeedlemanWunsch, SmithWaterman
from .ops.kernels import kernel_launch_counts, reset_kernel_launch_counts
from .ops.pack import kernel_params

__all__ = ["NeedlemanWunsch", "ScoringConfig", "SmithWaterman",
           "kernel_launch_counts", "kernel_params", "presets",
           "reset_kernel_launch_counts"]
