"""The one place that picks an engine for each public alignment path.

Engines:

* ``xla`` -- the row-scan engines in plain JAX (engine/xla_linmem.py,
  engine/xla_affine.py, the batched sweeps in engine/batch.py). They run
  on every platform and are the reference the kernel is checked against.
* the wavefront sweep kernel (kernels/sweep.cu), compiled for NVIDIA
  Hopper. It serves the paths in ``KERNEL_PATHS``: each of them was
  measured faster end to end on an H100 than its XLA engine (PERF.md).
  Full-matrix traceback, ``align_batch`` and the multi-device stripes
  have no kernel form and always run XLA.

The public ``engine`` argument is ``"auto"`` (the kernel where this module
routes to it, XLA elsewhere) or ``"xla"`` (always the XLA engines).
"""
from __future__ import annotations

import jax

ENGINES = ("auto", "xla")

# Paths the kernel serves on a GPU:
#   "score"  -- single-pair score passes (align_score, and the forward and
#               reverse passes of Hirschberg / Myers-Miller construction)
#   "levels" -- the batched half-problem sweep of each construction level
#   "batch"  -- align_scores_batch
KERNEL_PATHS = frozenset({"score", "levels", "batch"})


def check(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {ENGINES}"
        )
    return engine


def platform() -> str:
    """Platform of JAX's default device ("cpu", "gpu", ...)."""
    return jax.devices()[0].platform


def use_kernel(path: str, engine: str, rows: int) -> bool:
    """True when ``path`` (one of ``KERNEL_PATHS``) with ``rows`` padded
    query rows runs the sweep kernel: engine "auto", a GPU, and a height
    within one launch's grid."""
    from anyseq_tpu.kernels import sweep

    if path not in KERNEL_PATHS:
        raise ValueError(f"unknown path {path!r}")
    return (check(engine) == "auto" and platform() == "gpu"
            and rows <= sweep.MAX_ROWS)
