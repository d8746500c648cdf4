"""Spatial reuse passes and the exact-offset halo gather (reference
``romis_tpu/ops/pallas_spatial.py``).

Kernel 5 (``csrc/spatial.cu``, ``spatial_pass_fused``) replaces the Pallas
``_pass_kernel``: one biased spatial-reuse pass per pixel (R neighbour
offsets, depth and normal gates, stream weights, a Gumbel race per lane and
the combine) with the reservoir state in the ``[10K, H, W]`` plane layout
in and out, so the passes chain without re-packing. Kernel 11 (the same
source, ``spatial_pass_unbiased_fused``) replaces ``_pass_unbiased_kernel``:
the race without gates and a second sweep that counts Z at each
neighbour's own context. Kernel 9 (``csrc/halo.cu``, ``halo_offset_gather``)
replaces ``_offset_gather_kernel``: planes gathered at exact per-pixel
offsets, indices clamped into the image.

The plain versions do what the JAX XLA path does: a gather by indexing at
per-pixel offsets, then ``render.restir.spatial_pass`` (the gates and
``ops.wrs.combine_biased`` or ``combine_unbiased``). The TPU kernel shares
the row offset dy along each row of its 128-wide tile; the port draws both
offsets per pixel, as the JAX XLA path does.

Random numbers: ``inject`` = (offsets [2, R, H, W] int, Gumbel noise
[R+1, K, H, W]), the draws of ``spatial_noise``, drive both versions
identically. Without it, the plain version draws them from ``generator``
and the kernel from Philox keyed by ``key`` (a device int64 tensor from
``philox_key``: no host synchronisation), with the pass index in the
counter. Whether a frame runs these passes at all is
``render.restir.spatial_reuse``'s choice: with ``fused_resampling`` on
CUDA tensors (the reference's Pallas-on-TPU gate); otherwise it gathers
through ``halo_offset_gather`` (or coherent slices) and combines with
differentiable tensor code.

Kernel 10 (``csrc/halo.cu``, ``halo_offset_scatter``) replaces
``_offset_scatter_kernel``: the transpose of the clamped gather, and the
backward of ``halo_offset_gather`` (an autograd Function, so gradients
reach the gathered planes); its plain version is ``index_add_``.

Bound on the H100: the passes are compute-bound, (R+1)·K target-PDF
evaluations with one ``powf`` each per pixel (2·R·K more for the unbiased
Z); the neighbour reads stay within ±radius and are served mostly by L1
and L2. The halo gather is bound by device-memory bandwidth, the scatter
by bandwidth and atomics (D inputs land on a source pixel on average; the
clamped border pixels take more).
"""

from __future__ import annotations

import torch

from romis_tpu.core.features import Features

from ..core.types import (
    ShadeCtx, pack_reservoir_planes, unpack_reservoir_planes,
)
from . import _build

MAX_LANES = 4  # the pass kernels are instantiated for K = 1..4
MAX_UNBIASED_NEIGHBOURS = 8  # the unbiased kernel keeps R offsets in registers
# Philox counter tags of the pass kernels (RIS uses tag 0).
_TAG_BIASED, _TAG_UNBIASED = 0x5350, 0x5351


def pack_gates(ctx: ShadeCtx) -> torch.Tensor:
    """ShadeCtx → the [5, H, W] similarity-gate block: normal3 | depth |
    valid."""
    return torch.cat([ctx.normal, ctx.depth_t[None],
                      ctx.valid.float()[None]], dim=0)


def unpack_center_ctx(cen: torch.Tensor) -> ShadeCtx:
    """[..., 18, H, W] (``ops.shade.pack_center_ctx``) → ShadeCtx (geom_id
    is not packed and comes back as 0)."""
    def c(i, j=None):
        return cen[..., i:j, :, :] if j is not None else cen[..., i, :, :]

    return ShadeCtx(valid=c(17) > 0.5, position=c(0, 3), normal=c(3, 6),
                    view_origin=c(6, 9), kd=c(9, 12), ks=c(12, 15),
                    shininess=c(15), depth_t=c(16),
                    geom_id=torch.zeros(c(16).shape, dtype=torch.int32,
                                        device=cen.device))


def philox_key(generator: torch.Generator) -> torch.Tensor:
    """A 62-bit Philox key [1] int64, drawn on the generator's device
    without a host synchronisation."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator,
                         dtype=torch.int64, device=generator.device)


def spatial_noise(generator: torch.Generator, n_nbr: int, k: int,
                  radius: int, height: int, width: int):
    """The plain version's draws for one pass: offsets [2, R, H, W] int32,
    uniform in [-radius, radius], and Gumbel noise [R+1, K, H, W]."""
    from .wrs import gumbel_noise

    offs = torch.randint(-radius, radius + 1, (2, n_nbr, height, width),
                         generator=generator, dtype=torch.int32,
                         device=generator.device)
    return offs, gumbel_noise(generator, (n_nbr + 1, k, height, width))


def clamped_offsets(offs: torch.Tensor, height: int, width: int):
    """Offsets [2, R, H, W] → (dy, dx) [R, H, W] that stay on the screen:
    ny = clip(y + dy, 0, H-1) - y, likewise x (render_utils.cpp:109-110)."""
    dev = offs.device
    rows = torch.arange(height, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    dy = torch.clamp(rows + offs[0], 0, height - 1) - rows
    dx = torch.clamp(cols + offs[1], 0, width - 1) - cols
    return dy, dx


def halo_offset_gather_plain(planes: torch.Tensor, dy: torch.Tensor,
                             dx: torch.Tensor) -> torch.Tensor:
    """The plain version: indexing at the clamped coordinates."""
    _, h, w = planes.shape
    dev = planes.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    ny = torch.clamp(rows + dy.long(), 0, h - 1)
    nx = torch.clamp(cols + dx.long(), 0, w - 1)
    return planes[:, ny, nx].movedim(1, 0)


def _check_offsets(name, planes_hw, dy, dx):
    """dy/dx as contiguous int32 [D, H, W] matching the planes' (H, W)."""
    dyi = dy.to(torch.int32).contiguous()
    dxi = dx.to(torch.int32).contiguous()
    _build.check(dyi, "dy", torch.int32)
    _build.check(dxi, "dx", torch.int32, dyi.shape)
    if dyi.dim() != 3 or tuple(dyi.shape[1:]) != tuple(planes_hw):
        raise ValueError(f"{name}: offsets {tuple(dyi.shape)} do not match "
                         f"planes of {tuple(planes_hw)} pixels")
    return dyi, dxi


def _halo_gather_forward(planes, dy, dx):
    if not planes.is_cuda:
        return halo_offset_gather_plain(planes, dy, dx)
    c, h, w = planes.shape
    dyi, dxi = _check_offsets("halo_offset_gather", (h, w), dy, dx)
    planes = planes.contiguous()
    _build.check(planes, "planes", torch.float32)
    d = dyi.shape[0]
    out = torch.empty((d, c, h, w), dtype=torch.float32, device=planes.device)
    if out.numel():
        _build.launch("romis_halo_gather", planes.data_ptr(), c, h, w,
                      dyi.data_ptr(), dxi.data_ptr(), d * h * w,
                      out.data_ptr())
        halo_offset_gather.launches += 1
    return out


def halo_offset_scatter_plain(ct: torch.Tensor, dy: torch.Tensor,
                              dx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``index_add_`` at the clamped coordinates (the
    gather's segment-sum VJP)."""
    d, c, h, w = ct.shape
    dev = ct.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    q = (torch.clamp(rows + dy.long(), 0, h - 1) * w
         + torch.clamp(cols + dx.long(), 0, w - 1))  # [D, H, W]
    out = torch.zeros((c, h * w), dtype=torch.float32, device=dev)
    return out.index_add_(1, q.reshape(-1),
                          ct.movedim(1, 0).reshape(c, -1)).reshape(c, h, w)


def halo_offset_scatter(ct: torch.Tensor, dy: torch.Tensor,
                        dx: torch.Tensor) -> torch.Tensor:
    """The transpose of ``halo_offset_gather``: ct [D, C, H, W] f32 →
    [C, H, W] with out[c, clamp(i + dy), clamp(j + dx)] += ct[d, c, i, j].
    Kernel 10 for CUDA tensors, the plain version for CPU tensors."""
    if not ct.is_cuda:
        return halo_offset_scatter_plain(ct, dy, dx)
    d, c, h, w = ct.shape
    dyi, dxi = _check_offsets("halo_offset_scatter", (h, w), dy, dx)
    if dyi.shape[0] != d:
        raise ValueError(f"halo_offset_scatter: {dyi.shape[0]} offsets for "
                         f"{d} gathered copies")
    ctc = ct.contiguous()
    _build.check(ctc, "ct", torch.float32)
    out = torch.zeros((c, h, w), dtype=torch.float32, device=ct.device)
    if ctc.numel():
        _build.launch("romis_halo_scatter", ctc.data_ptr(), c, h, w,
                      dyi.data_ptr(), dxi.data_ptr(), d * h * w,
                      out.data_ptr())
        halo_offset_scatter.launches += 1
    return out


halo_offset_scatter.launches = 0


class _HaloGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, dy, dx):
        ctx.save_for_backward(dy, dx)
        return _halo_gather_forward(planes, dy, dx)

    @staticmethod
    def backward(ctx, ct):
        dy, dx = ctx.saved_tensors
        return halo_offset_scatter(ct, dy, dx), None, None


def halo_offset_gather(planes: torch.Tensor, dy: torch.Tensor,
                       dx: torch.Tensor) -> torch.Tensor:
    """out[d, c, i, j] = planes[c, i + dy[d, i, j], j + dx[d, i, j]], the
    coordinates clamped into the image. planes [C, H, W] f32, dy/dx
    [D, H, W] int → [D, C, H, W]. Kernel 9 for CUDA tensors, the plain
    version for CPU tensors; differentiable in ``planes``, with
    ``halo_offset_scatter`` as the backward."""
    if planes.requires_grad and torch.is_grad_enabled():
        return _HaloGather.apply(planes, dy, dx)
    return _halo_gather_forward(planes, dy, dx)


halo_offset_gather.launches = 0


def _noise(generator, inject, n_nbr, k, radius, h, w):
    if inject is not None:
        return inject
    if generator is None:
        raise ValueError("a spatial pass needs a torch.Generator or the "
                         "injected noise")
    return spatial_noise(generator, n_nbr, k, radius, h, w)


def _gather_neighbours(res_planes, extra, k, offs):
    """The R neighbours of every pixel → (their reservoirs, fields
    [R, K, ..., H, W], and their gathered ``extra`` planes [R, C, H, W])."""
    h, w = res_planes.shape[-2:]
    dy, dx = clamped_offsets(offs, h, w)
    g = halo_offset_gather_plain(torch.cat([res_planes, extra]), dy, dx)
    return unpack_reservoir_planes(g[:, :10 * k], k), g[:, 10 * k:]


def _gate_ctx(g: torch.Tensor) -> ShadeCtx:
    """Gathered gate planes [R, 5, H, W] → the neighbours' ShadeCtx
    (normal, depth, valid; the other fields are not gathered and read 0)."""
    z3 = torch.zeros_like(g[:, 0:3])
    zs = torch.zeros_like(g[:, 3])
    return ShadeCtx(valid=g[:, 4] > 0.5, position=z3, normal=g[:, 0:3],
                    view_origin=z3, kd=z3, ks=z3, shininess=zs,
                    depth_t=g[:, 3], geom_id=torch.zeros_like(zs).int())


def spatial_pass_plain(res_planes: torch.Tensor, gates: torch.Tensor,
                       cen_ctx: torch.Tensor, k: int, n_nbr: int,
                       radius: int, features: Features, generator=None,
                       key=None, pass_index: int = 0,
                       inject=None) -> torch.Tensor:
    """The plain version of one biased pass → fresh [10K, H, W] planes."""
    from ..render.restir import spatial_pass

    h, w = res_planes.shape[-2:]
    offs, gumbel = _noise(generator, inject, n_nbr, k, radius, h, w)
    nbr, g = _gather_neighbours(res_planes, gates, k, offs)
    out = spatial_pass(unpack_center_ctx(cen_ctx),
                       unpack_reservoir_planes(res_planes, k), nbr,
                       _gate_ctx(g),
                       features.replace(unbiased_combination=False), gumbel)
    return pack_reservoir_planes(out)


def spatial_pass_unbiased_plain(res_planes: torch.Tensor,
                                cen_ctx: torch.Tensor, k: int, n_nbr: int,
                                radius: int, features: Features,
                                generator=None, key=None, pass_index: int = 0,
                                inject=None, geometry=None,
                                any_hit=None) -> torch.Tensor:
    """The plain version of one unbiased pass → fresh [10K, H, W] planes.
    With ``spatial_reuse_visibility_check`` the Z visibility runs through
    ``any_hit`` (the plain block scan by default)."""
    from ..render.restir import spatial_pass
    from .intersect import intersect_any

    h, w = res_planes.shape[-2:]
    offs, gumbel = _noise(generator, inject, n_nbr, k, radius, h, w)
    nbr, g = _gather_neighbours(res_planes, cen_ctx, k, offs)
    out = spatial_pass(unpack_center_ctx(cen_ctx),
                       unpack_reservoir_planes(res_planes, k), nbr,
                       unpack_center_ctx(g),
                       features.replace(unbiased_combination=True), gumbel,
                       geometry=geometry, any_hit=any_hit or intersect_any)
    return pack_reservoir_planes(out)


def _launch_pass(name, wrapper, res_planes, gates, cen_ctx, k, n_nbr,
                 radius, features, key, pass_index, inject, unbiased):
    h, w = cen_ctx.shape[-2:]
    if not features.enable_shading:
        raise NotImplementedError(
            "the spatial pass kernels compute Phong target PDFs; the "
            "unshaded (enable_shading=False) pass has no kernel yet")
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"{name}: K={k} outside 1..{MAX_LANES}")
    if unbiased and n_nbr > MAX_UNBIASED_NEIGHBOURS:
        raise ValueError(f"{name}: {n_nbr} neighbours exceed the kernel's "
                         f"{MAX_UNBIASED_NEIGHBOURS}")
    if h * w >= 2 ** 31:
        raise ValueError(f"{name}: {h}x{w} pixels exceed 32-bit indexing")
    _build.check(res_planes, "res_planes", torch.float32, (10 * k, h, w))
    _build.check(cen_ctx, "cen_ctx", torch.float32, (18, h, w))
    if gates is not None:
        _build.check(gates, "gates", torch.float32, (5, h, w))
    if inject is not None:
        offs = inject[0].to(torch.int32).contiguous()
        gumbel = inject[1].contiguous()
        _build.check(offs, "offsets", torch.int32, (2, n_nbr, h, w))
        _build.check(gumbel, "gumbel", torch.float32, (n_nbr + 1, k, h, w))
        key_ptr, o_ptr, g_ptr = None, offs.data_ptr(), gumbel.data_ptr()
    else:
        if key is None:
            raise ValueError(f"{name}: needs a Philox key or injected noise")
        _build.check(key, "key", torch.int64, (1,))
        key_ptr, o_ptr, g_ptr = key.data_ptr(), None, None
    tag = ((_TAG_UNBIASED if unbiased else _TAG_BIASED) << 16) | (
        pass_index & 0xFFFF)
    out = torch.empty((10 * k, h, w), dtype=torch.float32,
                      device=res_planes.device)
    if h * w:
        _build.launch("romis_spatial_pass", res_planes.data_ptr(),
                      None if gates is None else gates.data_ptr(),
                      cen_ctx.data_ptr(), h, w, k, n_nbr, radius,
                      int(unbiased), key_ptr, tag, o_ptr, g_ptr,
                      out.data_ptr())
        wrapper.launches += 1
    return out


def spatial_pass_fused(res_planes: torch.Tensor, gates: torch.Tensor,
                       cen_ctx: torch.Tensor, k: int, n_nbr: int,
                       radius: int, features: Features, generator=None,
                       key=None, pass_index: int = 0,
                       inject=None) -> torch.Tensor:
    """One biased spatial-reuse pass: res_planes [10K, H, W]
    (``pack_reservoir_planes`` order), gates [5, H, W] (``pack_gates``),
    cen_ctx [18, H, W] (``ops.shade.pack_center_ctx``) → a fresh
    [10K, H, W]. Kernel 5 for CUDA tensors (Philox ``key`` or ``inject``),
    the plain version for CPU tensors (``generator`` or ``inject``)."""
    if not res_planes.is_cuda:
        return spatial_pass_plain(res_planes, gates, cen_ctx, k, n_nbr,
                                  radius, features, generator, key,
                                  pass_index, inject)
    return _launch_pass("spatial_pass", spatial_pass_fused, res_planes,
                        gates.contiguous(), cen_ctx, k, n_nbr, radius,
                        features, key, pass_index, inject, False)


spatial_pass_fused.launches = 0


def spatial_pass_unbiased_fused(res_planes: torch.Tensor,
                                cen_ctx: torch.Tensor, k: int, n_nbr: int,
                                radius: int, features: Features,
                                generator=None, key=None, pass_index: int = 0,
                                inject=None) -> torch.Tensor:
    """One unbiased spatial-reuse pass (no visibility in Z): res_planes
    [10K, H, W], cen_ctx [18, H, W] (the receiver and the neighbours'
    contexts) → a fresh [10K, H, W]. Kernel 11 for CUDA tensors, the plain
    version for CPU tensors."""
    if not res_planes.is_cuda:
        return spatial_pass_unbiased_plain(res_planes, cen_ctx, k, n_nbr,
                                           radius, features, generator, key,
                                           pass_index, inject)
    if features.spatial_reuse_visibility_check:
        raise NotImplementedError(
            "the unbiased pass with spatial_reuse_visibility_check needs the "
            "Z-count occlusion kernel (pallas_zcount_occ), ported in a later "
            "slice")
    return _launch_pass("spatial_pass_unbiased", spatial_pass_unbiased_fused,
                        res_planes, None, cen_ctx, k, n_nbr, radius, features,
                        key, pass_index, inject, True)


spatial_pass_unbiased_fused.launches = 0
