"""anyseq_tpu -- pairwise sequence alignment on accelerators with JAX.

A from-scratch JAX/XLA re-design of the capabilities of DasNaCl/anyseq:
global (Needleman-Wunsch), semiglobal and local (Smith-Waterman) alignment
with linear and affine gap scoring, in score-only, full-matrix-traceback
and linear-memory (Hirschberg / Myers-Miller) modes; a wavefront sweep
kernel for NVIDIA Hopper GPUs, a many-pair batched mode, and multi-device
subject-sharded wavefronts over a JAX device mesh.
"""
import os as _os

import jax as _jax

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is set
# (JAX reads it itself), else a fixed directory inside the checkout, so a
# second process finds what the first compiled.
CACHE_DIR = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from anyseq_tpu.core.types import (
    Alignment,
    AffineScoring,
    LinearScoring,
    Mode,
)
from anyseq_tpu.engine.api import align, align_full_tb, align_score
from anyseq_tpu.engine.batch import align_batch, align_scores_batch

__all__ = [
    "Alignment",
    "AffineScoring",
    "LinearScoring",
    "Mode",
    "align",
    "align_batch",
    "align_full_tb",
    "align_score",
    "align_scores_batch",
]

__version__ = "0.1.0"
