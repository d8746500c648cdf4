"""romis_tpu_torch — the renderer of ``romis_tpu`` (ReSTIR, R-MIS and
R-OMIS) in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

Module for module this package mirrors ``romis_tpu`` (the JAX reference it
is tested against) and keeps its image-minor ``[C, H, W]`` plane layout at
every public function. Plain tensor code is PyTorch; each Pallas kernel on
the ported path is a CUDA C++ kernel under ``csrc/``, compiled with ``nvcc``
at first use (``ops/_build.py``). Every kernel wrapper runs its plain
PyTorch version for CPU tensors and launches the kernel for CUDA tensors.

The package imports nothing of ``romis_tpu``: it keeps its own copies of
the reference's framework-free modules (``core.features``,
``scene.objloader``, ``io.image``). Entry points place their tensors on
the CUDA device unless given ``device=`` (``core.device``).
"""

from .core.features import (
    Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
)

__all__ = ["Features", "MISWeight", "NeighbourSelectionStrategy",
           "RayTraceMode"]
