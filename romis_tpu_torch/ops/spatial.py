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
``render.restir.spatial_reuse``'s choice: with ``fused_resampling`` and
``fused_spatial_gather`` on CUDA tensors (the reference's Pallas-on-TPU
gate); otherwise it gathers through ``halo_offset_gather`` (or coherent
slices) and combines with differentiable tensor code.

Kernel 11's ``vis_check`` mode (``Features.spatial_reuse_visibility_check``,
the reference's ``vis_check``) also writes Z before visibility, p̂ of the
winner, the neighbours' resolved positions and each (neighbour, lane)'s
m·[p̂_n(winner) > 0]. ``spatial_pass_unbiased_fused`` then traces the
(R+1)·K Z rays (kernel 7, ``ops.trace.zcount_occ``, on a soup; on geometry
with a BVH ``ops.wrs.visibility_from`` through ``ops.trace.any_hit``, i.e.
the walk kernels 20 or 19), takes the occluded inputs' terms out of Z and
re-derives W (``z_visibility``, the reference's
``pallas_spatial.py:1084-1112``). ``spatial_pass_unbiased_vis_plain`` is
the plain form of the mode's planes.

Both pass kernels have the unshaded mode of
``Features(enable_shading=False)``: every p̂ is the norm of the evaluating
context's kd.

Kernel 10 (``csrc/halo.cu``, ``halo_offset_scatter``) replaces
``_offset_scatter_kernel`` (the TPU's (2r+1)² masked shifts a tile, radius
≤ 64): the transpose of the clamped gather, and the backward of
``halo_offset_gather`` (an autograd Function, so gradients reach the
gathered planes), for offsets that may be any integer; its plain version
is ``index_add_``. A thread per source adding into device memory, as
``index_add_`` does, waits on the L2's atomic units (D·C·H·W float atomics
on C·H·W addresses), far above the bytes it must move. The kernel keeps
those adds on chip: a block takes a 16×32 tile of sources, loads their
offsets and cotangents together, adds each source whose clamped target
lies within ``HALO_SCATTER_MARGIN`` of it into a shared-memory window (the
tile ± the margin), and adds the window to the output once. A source whose
target lies beyond the margin (``beyond_margin``: large camera shifts,
offsets clamped from outside the image) goes straight to device memory
with an atomic; the kernel finds these sources itself, without asking the
host for the largest offset.

Kernel 12 (``csrc/nbrgather.cu``, ``neighbour_gather``) replaces
``_gather_kernel``: the planes of R random neighbours per pixel, offsets
drawn in the kernel (Philox, counter tag 0x5352) or given. The reference
reaches it on no frame path (``restir.py:487-499`` lies behind its two
fused pass branches), so the port's entry is the op alone. The TPU kernel
shares dx down each column of its tile; the port draws dy and dx per pixel.
Its plain version is the clamped gather at the offsets, and
``neighbour_offsets`` draws the kernel's Philox offsets in PyTorch
(``philox4x32_10``), so the CPU path and the kernel agree bit for bit on
both.

Bound on the H100: the passes are compute-bound, (R+1)·K target-PDF
evaluations with one ``powf`` each per pixel (2·R·K more for the unbiased
Z; the vis_check mode writes 2K + 3R + RK planes more); the neighbour
reads stay within ±radius and are served mostly by L1 and L2. The halo
gather is bound by device-memory bandwidth, the scatter by bandwidth once
its adds stay in shared memory (above); the neighbour gather by bandwidth
too, R·C planes written for C read.
"""

from __future__ import annotations

import torch

from ..core.features import Features

from ..core.types import (
    ShadeCtx, pack_reservoir_planes, unpack_reservoir_planes,
)
from . import _build

MAX_LANES = 4  # the pass kernels are instantiated for K = 1..4
MAX_UNBIASED_NEIGHBOURS = 8  # the unbiased kernel keeps R offsets in registers
# Kernel 10's accumulator window: its source tile +- this many pixels
# (csrc/halo.cu kMargin); a source whose target lies further is "far".
HALO_SCATTER_MARGIN = 16
# Philox counter tags of the pass kernels and the neighbour gather (RIS
# uses tag 0).
_TAG_BIASED, _TAG_UNBIASED, _TAG_GATHER = 0x5350, 0x5351, 0x5352


def vis_check_planes(k: int, n_nbr: int) -> int:
    """Planes of the vis_check block: Z before visibility (K), p̂ of the
    winner (K), the neighbours' positions (3R), their m·[p̂ > 0] (R·K)."""
    return 2 * k + 3 * n_nbr + n_nbr * k


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
    if h * w >= 2 ** 31:
        raise ValueError(f"halo_offset_scatter: {h}x{w} pixels exceed "
                         f"32-bit indexing")
    out = torch.zeros((c, h, w), dtype=torch.float32, device=ct.device)
    if ctc.numel():
        _build.launch("romis_halo_scatter", ctc.data_ptr(), d, c, h, w,
                      dyi.data_ptr(), dxi.data_ptr(), out.data_ptr())
        halo_offset_scatter.launches += 1
    return out


halo_offset_scatter.launches = 0


def beyond_margin(dy: torch.Tensor, dx: torch.Tensor,
                  margin: int = HALO_SCATTER_MARGIN) -> torch.Tensor:
    """The sources kernel 10 adds straight into device memory: those whose
    clamped target lies more than ``margin`` pixels from them in y or in x.
    dy/dx [D, H, W] int → bool [D, H, W]."""
    h, w = dy.shape[-2:]
    rows = torch.arange(h, device=dy.device)[:, None]
    cols = torch.arange(w, device=dy.device)[None, :]
    ty = torch.clamp(rows + dy.long(), 0, h - 1)
    tx = torch.clamp(cols + dx.long(), 0, w - 1)
    return ((ty - rows).abs() > margin) | ((tx - cols).abs() > margin)


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


_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of m·x for a 32-bit constant m and int64
    words x < 2^32; x is split in 16-bit halves so nothing overflows int64."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    lo = a + ((b & 0xFFFF) << 16)
    return ((b >> 16) + (lo >> 32)) & _MASK32, lo & _MASK32


def philox4x32_10(ctr, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words, word for word
    ``csrc/common.cuh``'s ``philox4x32_10`` → its four output words."""
    x, y, z, w = ctr
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, x)
        hi1, lo1 = _mulhilo(0xCD9E8D57, z)
        x, y, z, w = hi1 ^ y ^ k0, lo1, hi0 ^ w ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return x, y, z, w


def _offset_from(bits: torch.Tensor, radius: int) -> torch.Tensor:
    """``common.cuh``'s ``offset_from``: the top 24 bits as a float in
    [0, 1), scaled to 2r + 1 cells in float32 → int32 in [-r, r]."""
    u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return torch.clamp_max((u * float(2 * radius + 1)).to(torch.int32),
                           2 * radius) - radius


def neighbour_offsets(key: torch.Tensor, pass_index: int, n_nbr: int,
                      radius: int, height: int, width: int) -> torch.Tensor:
    """The offsets kernel 12 draws with ``key``, drawn here in PyTorch →
    [2, R, H, W] int32, uniform on [-radius, radius] (``spatial_noise``'s
    layout): Philox4x32-10 at counter (neighbour, pixel, pixel >> 32, tag),
    its first word dy, its second dx."""
    dev = key.device
    p = torch.arange(height * width, dtype=torch.int64, device=dev)[None]
    nb = torch.arange(n_nbr, dtype=torch.int64, device=dev)[:, None]
    tag = (_TAG_GATHER << 16) | (pass_index & 0xFFFF)
    k = key.to(torch.int64)
    x, y, _, _ = philox4x32_10(
        (nb.expand(n_nbr, height * width), (p & _MASK32).expand(n_nbr, -1),
         (p >> 32).expand(n_nbr, -1),
         torch.full((n_nbr, height * width), tag, dtype=torch.int64,
                    device=dev)),
        k & _MASK32, (k >> 32) & _MASK32)
    return torch.stack([_offset_from(x, radius), _offset_from(y, radius)]
                       ).reshape(2, n_nbr, height, width)


def neighbour_gather_plain(planes: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel 12: the clamped gather at ``offsets``
    [2, R, H, W] → [R, C, H, W]."""
    _, h, w = planes.shape
    return halo_offset_gather_plain(planes, *clamped_offsets(offsets, h, w))


def neighbour_gather(planes: torch.Tensor, n_nbr: int, radius: int,
                     key=None, pass_index: int = 0,
                     offsets=None) -> torch.Tensor:
    """The planes of R random neighbours (the reference's
    ``spatial_neighbour_gather_pallas``): planes [C, H, W] f32 →
    [R, C, H, W], neighbour n of pixel (i, j) at (clamp(i + dy), clamp(j +
    dx)) with (dy, dx) uniform on [-radius, radius]^2, drawn per pixel and
    shared by the C planes. ``offsets`` [2, R, H, W] int (``spatial_noise``'s
    draws) are used as given; without them the offsets come from Philox
    keyed by ``key`` (``philox_key``) with the pass index in the counter,
    the same draws as ``neighbour_offsets``. The reference reaches its
    kernel on no frame path, and the port adds none: this is the op alone.
    Kernel 12 for CUDA tensors, the plain version for CPU tensors."""
    c, h, w = planes.shape
    if offsets is None and key is None:
        raise ValueError("neighbour_gather: needs a Philox key or offsets")
    if radius < 0:
        raise ValueError(f"neighbour_gather: radius {radius} < 0")
    if not planes.is_cuda:
        if offsets is None:
            offsets = neighbour_offsets(key, pass_index, n_nbr, radius, h, w)
        return neighbour_gather_plain(planes, offsets)
    planes = planes.contiguous()
    _build.check(planes, "planes", torch.float32)
    o_ptr = key_ptr = None
    if offsets is not None:
        offs = offsets.to(torch.int32).contiguous()
        _build.check(offs, "offsets", torch.int32, (2, n_nbr, h, w))
        o_ptr = offs.data_ptr()
    else:
        _build.check(key, "key", torch.int64, (1,))
        key_ptr = key.data_ptr()
    out = torch.empty((n_nbr, c, h, w), dtype=torch.float32,
                      device=planes.device)
    if out.numel():
        _build.launch("romis_neighbour_gather", planes.data_ptr(), c, h, w,
                      n_nbr, radius, o_ptr, key_ptr,
                      (_TAG_GATHER << 16) | (pass_index & 0xFFFF),
                      out.data_ptr())
        neighbour_gather.launches += 1
    return out


neighbour_gather.launches = 0


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


def spatial_pass_unbiased_vis_plain(res_planes: torch.Tensor,
                                    cen_ctx: torch.Tensor, k: int,
                                    n_nbr: int, radius: int,
                                    features: Features, generator=None,
                                    key=None, pass_index: int = 0,
                                    inject=None):
    """The plain form of kernel 11's vis_check mode → (planes [10K, H, W],
    W from Z before visibility; the block [vis_check_planes, H, W]), the
    kernel's arithmetic for p̂ (``target_pdf_planes``) and its order of
    summation for Z."""
    from ..render.restir import spatial_pass
    from .shading import target_pdf_planes

    h, w = res_planes.shape[-2:]
    offs, gumbel = _noise(generator, inject, n_nbr, k, radius, h, w)
    nbr, g = _gather_neighbours(res_planes, cen_ctx, k, offs)
    ctx, nctx = unpack_center_ctx(cen_ctx), unpack_center_ctx(g)
    f = features.replace(unbiased_combination=True,
                         spatial_reuse_visibility_check=False)
    out = spatial_pass(ctx, unpack_reservoir_planes(res_planes, k), nbr,
                       nctx, f, gumbel)
    comps = [out.pos[:, c] for c in range(3)] + [out.color[:, c]
                                                 for c in range(3)]
    p_star = target_pdf_planes(ctx, *comps, f)  # [K, H, W]
    z = torch.zeros_like(p_star)
    mf = []
    for s in range(n_nbr):
        ctx_s = ShadeCtx(**{fld: getattr(nctx, fld)[s] for fld in (
            "valid", "position", "normal", "view_origin", "kd", "ks",
            "shininess", "geom_id", "depth_t")})
        mf.append(torch.where(target_pdf_planes(ctx_s, *comps, f) > 0.0,
                              nbr.m[s], 0.0))
        z = z + mf[-1]
    mf = torch.stack(mf)  # [R, K, H, W]
    z = z + torch.where(p_star > 0.0, res_planes[7 * k:8 * k], 0.0)
    block = torch.cat([z, p_star, g[:, 0:3].reshape(3 * n_nbr, h, w),
                       mf.reshape(n_nbr * k, h, w)])
    return pack_reservoir_planes(out), block


def z_visibility(planes: torch.Tensor, block: torch.Tensor,
                 res_planes: torch.Tensor, cen_ctx: torch.Tensor, geometry,
                 k: int, n_nbr: int):
    """Kernel 11's vis_check outputs → the pass's planes with W re-derived
    from Z with visibility: the (R+1)·K rays from the receiver and the
    neighbours to the winners, masked by p̂* > 0 (self) and m·[p̂ > 0] > 0
    (neighbours), through ``ops.trace.zcount_occ`` (kernel 7) on a soup, or
    ``ops.wrs.visibility_from`` through ``ops.trace.any_hit`` on geometry
    with a BVH; then the occluded inputs' terms come out of Z (the
    reference's ``pallas_spatial.py:1084-1112``)."""
    from .trace import any_hit, zcount_occ
    from .wrs import SHADOW_RAY_EPSILON, visibility_from

    h, w = planes.shape[-2:]
    z_phat, p_star = block[:k], block[k:2 * k]
    nbr_pos = block[2 * k:2 * k + 3 * n_nbr].reshape(n_nbr, 3, h, w)
    nbr_mf = block[2 * k + 3 * n_nbr:].reshape(n_nbr, k, h, w)
    win_pos = planes[:3 * k].reshape(k, 3, h, w)
    origins = torch.cat([cen_ctx[None, 0:3], nbr_pos])  # [R+1, 3, H, W]
    if geometry.bvh is None:
        mask = torch.cat([(p_star > 0.0)[None], nbr_mf > 0.0])
        vis = ~zcount_occ(origins, win_pos, geometry, SHADOW_RAY_EPSILON,
                          mask)
    else:
        vis = visibility_from(origins[:, None], win_pos[None], geometry,
                              any_hit)
    self_term = torch.where((p_star > 0.0) & ~vis[0],
                            res_planes[7 * k:8 * k], 0.0)
    nbr_terms = torch.where(~vis[1:], nbr_mf, 0.0)
    z = z_phat - self_term - nbr_terms.sum(dim=0)
    w_sum = planes[6 * k:7 * k]
    cond = (p_star > 0.0) & (z > 0.0)
    big_w = torch.where(cond, w_sum / torch.where(cond, p_star * z, 1.0),
                        0.0)
    return torch.cat([planes[:8 * k], big_w, planes[9 * k:]])


def _launch_pass(name, wrapper, res_planes, gates, cen_ctx, k, n_nbr,
                 radius, features, key, pass_index, inject, unbiased,
                 vis_check=False):
    h, w = cen_ctx.shape[-2:]
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
    vis = torch.empty((vis_check_planes(k, n_nbr), h, w),
                      dtype=torch.float32, device=res_planes.device) \
        if vis_check else None
    if h * w:
        _build.launch("romis_spatial_pass", res_planes.data_ptr(),
                      None if gates is None else gates.data_ptr(),
                      cen_ctx.data_ptr(), h, w, k, n_nbr, radius,
                      int(unbiased), key_ptr, tag, o_ptr, g_ptr,
                      int(not features.enable_shading), out.data_ptr(),
                      None if vis is None else vis.data_ptr())
        wrapper.launches += 1
    return out if vis is None else (out, vis)


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


def spatial_pass_unbiased_vis(res_planes: torch.Tensor,
                              cen_ctx: torch.Tensor, k: int, n_nbr: int,
                              radius: int, features: Features,
                              generator=None, key=None, pass_index: int = 0,
                              inject=None):
    """Kernel 11's vis_check mode alone → (planes [10K, H, W], W from Z
    before visibility; the block [vis_check_planes, H, W]); the plain form
    for CPU tensors. ``spatial_pass_unbiased_fused`` finishes the pass."""
    if not res_planes.is_cuda:
        return spatial_pass_unbiased_vis_plain(res_planes, cen_ctx, k, n_nbr,
                                               radius, features, generator,
                                               key, pass_index, inject)
    return _launch_pass("spatial_pass_unbiased", spatial_pass_unbiased_fused,
                        res_planes, None, cen_ctx, k, n_nbr, radius, features,
                        key, pass_index, inject, True, vis_check=True)


def spatial_pass_unbiased_fused(res_planes: torch.Tensor,
                                cen_ctx: torch.Tensor, k: int, n_nbr: int,
                                radius: int, features: Features,
                                generator=None, key=None, pass_index: int = 0,
                                inject=None, geometry=None) -> torch.Tensor:
    """One unbiased spatial-reuse pass: res_planes [10K, H, W], cen_ctx
    [18, H, W] (the receiver and the neighbours' contexts) → a fresh
    [10K, H, W]. With ``spatial_reuse_visibility_check`` Z counts only the
    inputs that see the winner, traced against ``geometry``. Kernel 11 for
    CUDA tensors (its vis_check mode, then kernel 7 or the BVH walk, then
    ``z_visibility``), the plain version for CPU tensors."""
    if not res_planes.is_cuda:
        return spatial_pass_unbiased_plain(res_planes, cen_ctx, k, n_nbr,
                                           radius, features, generator, key,
                                           pass_index, inject, geometry)
    if features.spatial_reuse_visibility_check:
        if geometry is None:
            raise ValueError("spatial_pass_unbiased_fused: the visibility "
                             "check traces the Z rays; pass geometry")
        planes, block = spatial_pass_unbiased_vis(
            res_planes, cen_ctx, k, n_nbr, radius, features, key=key,
            pass_index=pass_index, inject=inject)
        return z_visibility(planes, block, res_planes, cen_ctx, geometry, k,
                            n_nbr)
    return _launch_pass("spatial_pass_unbiased", spatial_pass_unbiased_fused,
                        res_planes, None, cen_ctx, k, n_nbr, radius, features,
                        key, pass_index, inject, True)


spatial_pass_unbiased_fused.launches = 0
