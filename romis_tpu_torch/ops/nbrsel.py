"""Similarity-gated neighbour selection for R-MIS / R-OMIS (reference
``romis_tpu/ops/pallas_nbrsel.py`` and the XLA path of
``romis_tpu/render/neighbours.py``).

Per pixel, every in-image cell of the ±radius box (self excluded) is
classed similar or dissimilar by the gates of ``render.neighbours`` (same
geometry, depth within a fraction, normal within an angle) and scored; the
D best scores per class survive. One class (SIMILAR, DISSIMILAR): the score
is the noise plus 1e6 for the preferred class, so the preferred class ranks
first and the other fills the deficit. Two classes
(EQUAL_SIMILAR_DISSIMILAR): each class keeps its own top D, and the class
counts go to the torch tail in ``render.neighbours``.

Outputs hold the slots in rank order (score descending, ties to the earlier
box offset): scores [D, H, W] f32 (-inf for an empty slot) and box indices
[D, H, W] int32, (dy + r)·(2r + 1) + (dx + r), -1 for an empty slot; two
classes add the dissimilar slots and the counts [2, H, W] int32.

Kernel 16 (``csrc/nbrsel.cu``, ``neighbour_select``) replaces the Pallas
``_nbrsel_kernel``: one thread per pixel walks the whole box in the XLA
path's offset order, the gate planes of its block's window staged in shared
memory, and keeps the top D per class in registers as a sorted list, which
reproduces the plain version's ranking and its ties exactly. Its plain
version, ``neighbour_select_plain``, is the XLA path's streamed top-D:
offset blocks of 8, merged by repeated first-maximum extraction.

With Philox noise the kernel races on keys first: a cell's Gumbel score is
a non-decreasing function of its 24-bit uniform key (``gumbel_of_keys``;
the card checks the compiled function on all 2^24 keys through
``gumbel_table``), so a cell whose (class, key) is not above the D-th
largest so far cannot enter and is skipped before its logarithms, and in
one class before its gates while even its preferred (class, key) could
not pass; the cells that pass are scored in rounds across the warp.
``selection_keys`` rebuilds the kernel's keys for a Philox key
(Philox4x32-10 at counter (offset / 4, pixel, tag)).

Random numbers: ``scores`` [(2r+1)²-1, H, W], one noise plane per box
offset in the XLA order (dy-major, dx-minor, (0, 0) skipped), drive both
versions identically. Without them the plain version draws standard Gumbel
noise from ``generator`` and the kernel the same distribution from Philox
keyed by ``key`` (``ops.spatial.philox_key``), counter tag 0x4E53.

Bound on the H100: compute. Each pixel draws a Philox word for each of
the (2r+1)²-1 cells (440 at r = 10), evaluates the gates where the race
needs the class and 2 logarithms per entrant (all cells with injected
scores, which are read instead); device memory sees 5 gate planes in (plus
the score planes when injected) and 2D + (2D + 2) planes out.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import ShadeCtx
from . import _build

CLASS_OFFSET = 1e6  # ranks the preferred class above the other
MAX_NEIGHBOURS = 8  # the kernel is instantiated for D = 1..8
BLOCK = 8  # the plain version's offset block (the XLA path's scan step)
_TAG = 0x4E53
KEY_BITS = 24  # a uniform's key: the top 24 bits of its Philox word


def selection_gates(ctx: ShadeCtx) -> torch.Tensor:
    """ShadeCtx → [5, H, W] gate planes: geom_id (as f32) | depth |
    normal3."""
    return torch.cat([ctx.geom_id.float()[None], ctx.depth_t[None],
                      ctx.normal], dim=0)


def box_offsets(radius: int) -> np.ndarray:
    """The box offsets [(2r+1)²-1, 2] (dy, dx) in the XLA order."""
    return np.asarray([(dy, dx) for dy in range(-radius, radius + 1)
                       for dx in range(-radius, radius + 1)
                       if not (dy == 0 and dx == 0)], np.int32).reshape(-1, 2)


def selection_noise(generator: torch.Generator, radius: int, height: int,
                    width: int) -> torch.Tensor:
    """The plain version's draws: Gumbel noise, one plane per box offset."""
    from .wrs import gumbel_noise

    n_off = (2 * radius + 1) ** 2 - 1
    return gumbel_noise(generator, (n_off, height, width))


def selection_keys(key: torch.Tensor, radius: int, height: int,
                   width: int, chunk: int = 16) -> torch.Tensor:
    """The 24-bit uniform keys kernel 16 draws with Philox ``key`` →
    [(2r+1)²-1, H, W] int32, one plane per box offset: word o % 4 of
    Philox4x32-10 at counter (o // 4, pixel, pixel >> 32, 0x4E53 << 16),
    shifted right by 8 (``csrc/common.cuh``'s ``u01``). ``chunk`` counter
    values are drawn at a time."""
    from .spatial import _MASK32, philox4x32_10

    n_off = (2 * radius + 1) ** 2 - 1
    n = height * width
    dev = key.device
    k = key.to(torch.int64)
    k0, k1 = k & _MASK32, (k >> 32) & _MASK32
    pix = torch.arange(n, dtype=torch.int64, device=dev)[None]
    out = torch.empty((4 * -(-n_off // 4), n), dtype=torch.int32,
                      device=dev)
    for c0 in range(0, -(-n_off // 4), chunk):
        c = torch.arange(c0, min(c0 + chunk, -(-n_off // 4)),
                         dtype=torch.int64, device=dev)[:, None]
        shape = (c.shape[0], n)
        words = philox4x32_10(
            (c.expand(shape), (pix & _MASK32).expand(shape),
             (pix >> 32).expand(shape),
             torch.full(shape, _TAG << 16, dtype=torch.int64, device=dev)),
            k0, k1)
        out[4 * c0:4 * c0 + 4 * c.shape[0]] = (
            torch.stack(words, dim=1).reshape(-1, n) >> 8).to(torch.int32)
    return out[:n_off].reshape(n_off, height, width)


def gumbel_of_keys(keys: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel scores of 24-bit keys, as the kernel computes them
    (``gumbel_of_key``): -log(-log u), u = key / 2^24 floored at 1e-37,
    in float32 (``torch.log`` may differ from CUDA's ``logf`` by an
    ulp)."""
    u = keys.to(torch.float32) * (1.0 / 16777216.0)
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-37)))


def gumbel_table() -> torch.Tensor:
    """Kernel 16's own Gumbel score of every 24-bit key on the card →
    [2^24] f32: its key skip is exact only if this is non-decreasing."""
    out = torch.empty(1 << KEY_BITS, dtype=torch.float32, device="cuda")
    _build.launch("romis_gumbel_table", out.data_ptr())
    return out


def _similar(gates: torch.Tensor, nb: torch.Tensor, same_geom: bool,
             depth_frac: torch.Tensor, normal_cos: torch.Tensor):
    """The similarity gates of neighbour planes ``nb`` [5, H, W] against
    the pixel's own ``gates`` (render/neighbours._similar_planes)."""
    ok = torch.ones(gates.shape[-2:], dtype=torch.bool, device=gates.device)
    if same_geom:
        ok = ok & (nb[0] == gates[0])
    df = torch.abs(1.0 - gates[1] / torch.clamp_min(nb[1], 1e-20))
    ok = ok & (df <= depth_frac)
    ndot = gates[2] * nb[2] + gates[3] * nb[3] + gates[4] * nb[4]
    return ok & (ndot >= normal_cos)


def _merge_topd(best_s, best_p, blk_s, blk_p, d: int):
    """Top D of the D best and a block, by repeated first-maximum
    extraction (score descending, ties to the earlier entry)."""
    s = torch.cat([best_s, blk_s])
    p = torch.cat([best_p, blk_p])
    out_s, out_p = [], []
    for _ in range(d):
        am = torch.argmax(s, dim=0, keepdim=True)
        out_s.append(torch.gather(s, 0, am)[0])
        out_p.append(torch.gather(p, 0, am)[0])
        s = s.scatter(0, am, -torch.inf)
    return torch.stack(out_s), torch.stack(out_p)


def neighbour_select_plain(gates: torch.Tensor, d: int, radius: int,
                           two_classes: bool, prefer_similar: bool,
                           same_geom: bool, depth_frac: float,
                           normal_cos: float, generator=None, key=None,
                           scores=None):
    """The plain version: the XLA path's streamed top-D → (scores, packs)
    or, with ``two_classes``, (sim scores, sim packs, dis scores, dis packs,
    counts). ``key`` (the kernel's Philox key) is not read."""
    _, h, w = gates.shape
    dev = gates.device
    offs = box_offsets(radius)
    if scores is None:
        scores = selection_noise(generator, radius, h, w)
    if tuple(scores.shape) != (len(offs), h, w):
        raise ValueError(f"scores: expected {(len(offs), h, w)}, got "
                         f"{tuple(scores.shape)}")
    side = 2 * radius + 1
    dfrac = torch.tensor(depth_frac, dtype=torch.float32, device=dev)
    ncos = torch.tensor(normal_cos, dtype=torch.float32, device=dev)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    gpad = torch.nn.functional.pad(gates, (radius, radius, radius, radius))

    def empty():
        return (torch.full((d, h, w), -torch.inf, device=dev),
                torch.zeros((d, h, w), dtype=torch.int32, device=dev))

    race_a, race_b = empty(), empty()
    cnt = torch.zeros((2, h, w), dtype=torch.int32, device=dev)
    for b0 in range(0, len(offs), BLOCK):
        s_a, s_b, packs = [], [], []
        for o in range(b0, min(b0 + BLOCK, len(offs))):
            dy, dx = int(offs[o, 0]), int(offs[o, 1])
            in_b = ((rows + dy >= 0) & (rows + dy < h) & (cols + dx >= 0)
                    & (cols + dx < w))
            nb = gpad[:, radius + dy:radius + dy + h,
                      radius + dx:radius + dx + w]
            sim = _similar(gates, nb, same_geom, dfrac, ncos)
            g = scores[o]
            packs.append(torch.full((h, w), (dy + radius) * side
                                    + (dx + radius), dtype=torch.int32,
                                    device=dev))
            if two_classes:
                s_a.append(torch.where(in_b & sim, g, -torch.inf))
                s_b.append(torch.where(in_b & ~sim, g, -torch.inf))
                cnt[0] += (in_b & sim).int()
                cnt[1] += (in_b & ~sim).int()
            else:
                cls = sim if prefer_similar else ~sim
                s_a.append(torch.where(in_b, g + cls.float() * CLASS_OFFSET,
                                       -torch.inf))
        packs = torch.stack(packs)
        race_a = _merge_topd(*race_a, torch.stack(s_a), packs, d)
        if two_classes:
            race_b = _merge_topd(*race_b, torch.stack(s_b), packs, d)

    def finish(race):
        s, p = race
        return s, torch.where(torch.isfinite(s), p, -1)

    if two_classes:
        return (*finish(race_a), *finish(race_b), cnt)
    return finish(race_a)


def neighbour_select(gates: torch.Tensor, d: int, radius: int,
                     two_classes: bool, prefer_similar: bool, same_geom: bool,
                     depth_frac: float, normal_cos: float, generator=None,
                     key=None, scores=None):
    """Top-D neighbour slots per class over the ±radius box: gates
    [5, H, W] (``selection_gates``) → (scores, packs) or, with
    ``two_classes``, (sim scores, sim packs, dis scores, dis packs, counts).
    Kernel 16 for CUDA tensors (Philox ``key`` or ``scores``), the plain
    version for CPU tensors (``generator`` or ``scores``)."""
    if not gates.is_cuda:
        return neighbour_select_plain(gates, d, radius, two_classes,
                                      prefer_similar, same_geom, depth_frac,
                                      normal_cos, generator, key, scores)
    _, h, w = gates.shape
    if not 1 <= d <= MAX_NEIGHBOURS:
        raise ValueError(f"neighbour_select: D={d} outside "
                         f"1..{MAX_NEIGHBOURS}")
    if h * w >= 2 ** 31:
        raise ValueError(f"neighbour_select: {h}x{w} pixels exceed 32-bit "
                         "indexing")
    gates = gates.contiguous()
    _build.check(gates, "gates", torch.float32, (5, h, w))
    n_off = (2 * radius + 1) ** 2 - 1
    if scores is not None:
        scores = scores.contiguous()
        _build.check(scores, "scores", torch.float32, (n_off, h, w))
        key_ptr, s_ptr = None, scores.data_ptr()
    else:
        if key is None:
            raise ValueError("neighbour_select: needs a Philox key or the "
                             "score planes")
        _build.check(key, "key", torch.int64, (1,))
        key_ptr, s_ptr = key.data_ptr(), None
    dev = gates.device
    n_cls = 2 if two_classes else 1
    s_out = torch.empty((n_cls, d, h, w), dtype=torch.float32, device=dev)
    p_out = torch.empty((n_cls, d, h, w), dtype=torch.int32, device=dev)
    cnt = torch.empty((2, h, w), dtype=torch.int32, device=dev)
    if h * w:
        _build.launch("romis_neighbour_select", gates.data_ptr(), h, w, d,
                      radius, int(two_classes), int(prefer_similar),
                      int(same_geom), float(np.float32(depth_frac)),
                      float(np.float32(normal_cos)), key_ptr, _TAG << 16,
                      s_ptr, s_out.data_ptr(), p_out.data_ptr(),
                      cnt.data_ptr())
        neighbour_select.launches += 1
    if two_classes:
        return s_out[0], p_out[0], s_out[1], p_out[1], cnt
    return s_out[0], p_out[0]


neighbour_select.launches = 0
