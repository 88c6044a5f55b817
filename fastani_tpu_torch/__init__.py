"""fastani_tpu_torch — the ANI engine in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the ``fastani_tpu`` package (JAX/XLA/Pallas) that keeps its
layout and function names so each piece has an obvious counterpart.  It
imports neither ``jax`` nor anything of ``fastani_tpu``.

Public API:
    fastani_tpu_torch.config.Parameters   — run configuration
    fastani_tpu_torch.models.pipeline     — ``run_fast``, the fast ANI path
    fastani_tpu_torch.cli                 — ``python -m fastani_tpu_torch.cli``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
a CUDA tensor every kernel wrapper launches its kernel or raises, and only
a CPU tensor takes the plain PyTorch version of a kernel.
"""

__version__ = "0.1.0"
