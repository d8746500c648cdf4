"""Diagnostic images (reference ``romis_tpu/utils/debug_vis.py``): the
headless counterpart of the reference's GL ray drawing and R-OMIS alpha
views.

- hit/miss mask (camera rays green/red), depth, shading normals, submesh
  id, material albedo;
- the canonical samples' shadow-ray visibility per pixel (cyan clear, red
  blocked);
- reservoir heatmaps: M, W, wSum.

The primary hits, the canonical RIS and the shadow rays go through the
kernels (``render.restir.trace_primary``, ``ops.wrs.gen_canonical_samples``,
``ops.trace.any_hit``) on a CUDA device.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import CameraParams, generate_rays
from ..core.features import Features
from ..ops.trace import any_hit
from ..ops.wrs import gen_canonical_samples, visibility
from ..render.restir import trace_primary


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _to_img(x) -> np.ndarray:
    """[3, H, W] or [H, W] → [H, W, 3] in [0, 1]."""
    a = _np(x)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=0)
    return np.clip(np.moveaxis(a, 0, -1), 0.0, 1.0)


def _heat(a: np.ndarray, lo=None, hi=None) -> np.ndarray:
    """Scalar field → blue (0) to orange (1) heatmap."""
    a = np.asarray(a, np.float32)
    lo = np.nanmin(a) if lo is None else lo
    hi = np.nanmax(a) if hi is None else hi
    t = np.clip((a - lo) / max(hi - lo, 1e-12), 0, 1)
    return np.stack([t, np.full_like(t, 0.5), 1.0 - t], axis=-1)


def debug_images(generator, cam: CameraParams, scene, height: int,
                 width: int, features: Features) -> dict[str, np.ndarray]:
    """The diagnostic set → name → [H, W, 3] image. ``generator`` draws
    the canonical samples."""
    g, li, nl = scene.geometry, scene.lights, scene.num_lights
    rays = generate_rays(cam, height, width)
    hits, ctx = trace_primary(rays, g, features)

    out = {}
    hit = _np(hits.valid).astype(bool)
    out["hit_mask"] = np.where(hit[..., None], [0.2, 0.9, 0.2],
                               [0.9, 0.2, 0.2]).astype(np.float32)
    t = _np(hits.t)
    finite = np.isfinite(t)
    tmax = t[finite].max() if finite.any() else 1.0
    out["depth"] = _heat(np.where(finite, t, tmax), 0.0, tmax)
    out["normals"] = _to_img((hits.normal + 1.0) * 0.5)
    out["albedo"] = _to_img(ctx.kd)
    gid = _np(hits.geom_id)
    out["geom_id"] = _heat(np.where(gid >= 0, gid, 0), 0, max(gid.max(), 1))

    res = gen_canonical_samples(ctx, li, nl, g, features,
                                generator=generator)
    vis = _np(visibility(ctx.position, res.pos, g, any_hit)).mean(axis=0)
    out["shadow_visibility"] = (
        vis[..., None] * np.array([0.2, 0.9, 0.9])
        + (1 - vis)[..., None] * np.array([0.9, 0.2, 0.2])
    ).astype(np.float32)
    out["reservoir_m"] = _heat(_np(res.total_m()))
    out["reservoir_w"] = _heat(_np(res.big_w).mean(axis=0))
    out["reservoir_wsum"] = _heat(_np(res.w_sum).mean(axis=0))
    return out


def save_debug_images(prefix: str,
                      images: dict[str, np.ndarray]) -> list[str]:
    """Write each image as ``<prefix>_<name>.png`` → the paths."""
    from ..io.image import write_image

    paths = []
    for name, img in images.items():
        path = f"{prefix}_{name}.png"
        write_image(path, img)
        paths.append(path)
    return paths
