"""romis_tpu_torch — the ReSTIR renderer of ``romis_tpu`` in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

Module for module this package mirrors ``romis_tpu`` (the JAX reference it
is tested against) and keeps its image-minor ``[C, H, W]`` plane layout at
every public function. Plain tensor code is PyTorch; each Pallas kernel on
the ported path is a CUDA C++ kernel under ``csrc/``, compiled with ``nvcc``
at first use (``ops/_build.py``). Every kernel wrapper runs its plain
PyTorch version for CPU tensors and launches the kernel for CUDA tensors.

The framework-free reference modules are shared, not copied:
``romis_tpu.core.features``, ``romis_tpu.scene.objloader`` and
``romis_tpu.io.image``. None of them imports JAX.
"""

from romis_tpu.core.features import Features, RayTraceMode

__all__ = ["Features", "RayTraceMode"]
