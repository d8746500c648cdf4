"""Build and load the hand-written CUDA kernels (``romis_tpu_torch/csrc``).

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source, all
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``build/romis_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
the cached library. The build uses only the repository's sources and the
installed CUDA toolkit; a missing ``nvcc`` or a failed build raises.

The host-side SAH BVH builder (``csrc/host/bvh_builder.cpp``, the port's
own copy of the JAX package's native builder) is compiled the same way with
the host C++ compiler into its own library (``build_host``,
``host_library``); a missing compiler raises.

Nothing here runs at import time: ``library()`` and ``host_library()``
build on first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "romis_tpu_torch"

# --fmad=false: no multiply-add contraction, so each kernel rounds like the
# op-by-op plain PyTorch version it is checked against on the card.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _LL, _ULL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                             ctypes.c_longlong, ctypes.c_ulonglong,
                             ctypes.c_float)

# C entry points (each returns cudaGetLastError() after its launch) and
# their argument types; the last argument of each is the CUDA stream.
SIGNATURES = {
    # o, d, n_pix, tri_cols, n_tris, t_max, t, tri, u, v, stream
    "romis_closest_hit": (_P, _P, _LL, _P, _I, _F, _P, _P, _P, _P, _P),
    # table, n_rows, n_cols, idx, n_idx, out, stream
    "romis_gather_rows": (_P, _I, _I, _P, _LL, _P, _P),
    # ctx17, n_pix, light_rows, n_rows, num_lights, s, k, seed, uniforms,
    # out, unshaded, stream
    "romis_ris": (_P, _LL, _P, _I, _I, _I, _I, _ULL, _P, _P, _I, _P),
    # the same arguments; out holds the 7K replay-record planes
    "romis_ris_replay": (_P, _LL, _P, _I, _I, _I, _I, _ULL, _P, _P, _I, _P),
    # ctx18, res, n_pix, k, tri_cols, n_tris, unshaded, out, stream
    "romis_final_shade": (_P, _P, _LL, _I, _P, _I, _I, _P, _P),
    # origins, dirs, t_max, n_pix, n_rays, tri_cols, n_tris, out, stream
    "romis_any_hit": (_P, _P, _P, _LL, _LL, _P, _I, _P, _P),
    # planes, c, h, w, dy, dx, n_out, out, stream
    "romis_halo_gather": (_P, _I, _I, _I, _P, _P, _LL, _P, _P),
    # ct, d, c, h, w, dy, dx, out (zero-filled), stream
    "romis_halo_scatter": (_P, _I, _I, _I, _I, _P, _P, _P, _P),
    # ct, n_cols, idx, n_idx, n_rows, out, stream
    "romis_scatter_rows_add": (_P, _I, _P, _LL, _I, _P, _P),
    # the same arguments, then iters, romis, unshaded; out holds iters
    # pack blocks
    "romis_ris_mis": (_P, _LL, _P, _I, _I, _I, _I, _ULL, _P, _P, _I, _I, _I,
                      _P),
    # gates, h, w, d, radius, two_classes, prefer_similar, same_geom,
    # depth_frac, normal_cos, key, tag, scores, s_out, p_out, cnt, stream
    "romis_neighbour_select": (_P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P,
                               _U, _P, _P, _P, _P, _P),
    # out [2^24] (kernel 16's Gumbel score of every key), stream
    "romis_gumbel_table": (_P, _P),
    # cen, res, offs, nbr, alphas, ext_vis, tri_cols, n_tris, h, w, d1, k,
    # s, num_lights, mode, unshaded, out0, out1, out2, stream
    "romis_mis_iteration": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P, _P, _P, _P),
    # o, d, n_pix, nodes, tri_cols, n_tris, t_max, t, tri, u, v, stream
    "romis_bvh_closest": (_P, _P, _LL, _P, _P, _I, _F, _P, _P, _P, _P, _P),
    # origins, dirs, t_max, n_pix, n_rays, nodes, tri_cols, n_tris, out,
    # stream
    "romis_bvh_any": (_P, _P, _P, _LL, _LL, _P, _P, _I, _P, _P),
    # origins, dirs, t_max, n_pix, s, nodes, tri_records [T, 12], out,
    # stream
    "romis_bvh_any_k": (_P, _P, _P, _LL, _I, _P, _P, _P, _P),
    # ctx18, res, n_pix, k, nodes, tri_cols, n_tris, unshaded, out, stream
    "romis_final_shade_bvh": (_P, _P, _LL, _I, _P, _P, _I, _I, _P, _P),
    # res, gates, ctx18, h, w, k, n_nbr, radius, unbiased, key, tag, offs,
    # gumbel, unshaded, out, vis_check block, and with unbiased the
    # records [N, 8K] and [N, 16] (scratch), stream
    "romis_spatial_pass": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _U, _P,
                           _P, _I, _P, _P, _P, _P, _P),
    # origins, targets, mask, h, w, n_origins, k, tri_cols (block-ordered),
    # boxes, normals, n_tris, eps, out, stream
    "romis_zcount_occ": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _F, _P,
                         _P),
    # origins, dirs, t_max, n_pix, n_rays, cmat [5T, 16], n_tris, out, stream
    "romis_any_hit_plucker": (_P, _P, _P, _LL, _LL, _P, _I, _P, _P),
    # planes, c, h, w, n_nbr, radius, offs, key, tag, out, stream
    "romis_neighbour_gather": (_P, _I, _I, _I, _I, _I, _P, _P, _U, _P, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of romis_tpu_torch "
                           "are built with the CUDA toolkit at first use")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the cached library is missing or stale →
    path of the shared library. Each source compiles in its own ``nvcc``
    process, all at once; the compilers' reports (registers, shared memory,
    spills) are kept beside the library as ``build.log``."""
    lib = BUILD_DIR / f"libromis_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        start = time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                   str(Path(tmp) / f"{src.stem}.o"), str(src)]
            out = Path(tmp) / f"{src.stem}.log"
            with open(out, "w") as f:
                proc = subprocess.Popen(cmd, stdout=f,
                                        stderr=subprocess.STDOUT)
            jobs.append((cmd, proc, out))
        log, failed = [], []
        seconds = {}
        while len(seconds) < len(jobs):  # each source's compile seconds
            for cmd, proc, _ in jobs:
                if cmd[-1] not in seconds and proc.poll() is not None:
                    seconds[cmd[-1]] = time.perf_counter() - start
            time.sleep(0.05)
        for cmd, proc, out in jobs:
            text = out.read_text()
            log.append(" ".join(cmd) + "\n" + text + f"nvcc seconds "
                       f"{Path(cmd[-1]).name} {seconds[cmd[-1]]:.1f}\n")
            if proc.returncode != 0:
                failed.append(text)
        if not failed:
            tmp_lib = Path(tmp) / lib.name
            cmd = [nvcc, "-shared", "-o", str(tmp_lib),
                   *(cmd[cmd.index("-o") + 1] for cmd, _, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on the current CUDA stream; raise if the
    launch reported an error."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


HOST_SOURCE = CSRC / "host" / "bvh_builder.cpp"
# -ffp-contract=off: no multiply-add contraction in the SAH sums, so the
# tree does not depend on the host CPU (no -march=native either).
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")


def _cxx() -> str:
    for name in ("c++", "g++", "clang++"):
        path = shutil.which(name)
        if path is not None:
            return path
    raise RuntimeError("no C++ compiler found: the SAH BVH builder of "
                       "romis_tpu_torch (csrc/host/bvh_builder.cpp) is "
                       "compiled with the host compiler at first use")


def build_host() -> Path:
    """Compile the host BVH builder if its cached library is missing or
    stale → path of the shared library."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    lib = BUILD_DIR / f"libromis_bvh_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / lib.name
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp_lib),
                               str(HOST_SOURCE)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError("the host BVH builder failed to compile:\n"
                               + proc.stderr)
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def host_library() -> ctypes.CDLL:
    """The loaded host BVH builder (``bvh_build_sah``), built on first
    use."""
    lib = ctypes.CDLL(str(build_host()))
    lib.bvh_build_sah.argtypes = [_P, _P, _P, ctypes.c_int32, ctypes.c_int32,
                                  _P, _P, _P, _P, _P, _P, _P]
    lib.bvh_build_sah.restype = ctypes.c_int32
    return lib


def check(t, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and of
    ``shape``, where given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
