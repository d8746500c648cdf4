"""Carry a scene, a camera, scene parameters and a BVH over from the JAX
package.

The caller extracts the reference's arrays with ``np.asarray``; these
functions build the port's objects from them. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import CameraParams
from .core.device import resolve_device
from .scene.lights import COLUMNS as LIGHT_COLUMNS, light_table_from_arrays
from .scene.scene import COLUMNS as GEOMETRY_COLUMNS, Scene, geometry_from_arrays


def scene_from_numpy(geometry: dict[str, np.ndarray],
                     lights: dict[str, np.ndarray], num_lights: int,
                     device=None, name: str = "scene") -> Scene:
    """``geometry`` holds the reference Geometry's columns
    (``scene.scene.COLUMNS``: v0, e1, e2, n0..n2, uv0..uv2, mat_id, geom_id,
    active, the material table and the texture stack); ``lights`` the
    LightTable's columns (``scene.lights.COLUMNS`` and ``kind``). The packed
    row tables are rebuilt from the columns."""
    missing = [c for c in GEOMETRY_COLUMNS if c not in geometry]
    missing += [c for c in LIGHT_COLUMNS + ("kind",) if c not in lights]
    if missing:
        raise KeyError(f"scene_from_numpy: missing columns {missing}")
    return Scene(geometry=geometry_from_arrays(geometry, device),
                 lights=light_table_from_arrays(lights, device),
                 num_lights=int(num_lights), name=name)


def camera_from_numpy(look_at, rotation, distance, fovy, aspect,
                      device=None) -> CameraParams:
    """The reference CameraParams' fields (rotation and fovy in radians)."""
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return CameraParams(look_at=f32(look_at), rotation=f32(rotation),
                        distance=f32(distance), fovy=f32(fovy),
                        aspect=f32(aspect))


def params_from_numpy(params: dict[str, np.ndarray], device=None):
    """The reference SceneParams' 13 leaves (``diff.grad.SceneParams``
    field names) → the port's SceneParams."""
    from .diff.grad import SceneParams

    device = resolve_device(device)

    return SceneParams(**{
        f: torch.as_tensor(np.array(params[f], np.float32), device=device)
        for f in SceneParams.__dataclass_fields__})


def bvh_from_numpy(arrays: dict[str, np.ndarray], device=None):
    """The reference BVH's node columns (bmin_x/y/z, bmax_x/y/z, miss_link,
    leaf_first, leaf_count) → the port's ``ops.bvh.BVH``. Its leaves index
    the reference's permuted geometry, so carry that geometry over with
    ``scene_from_numpy`` and attach the result as ``geometry.bvh``."""
    from .ops.bvh import bvh_from_arrays

    fields = ("bmin_x", "bmin_y", "bmin_z", "bmax_x", "bmax_y", "bmax_z",
              "miss_link", "leaf_first", "leaf_count")
    missing = [f for f in fields if f not in arrays]
    if missing:
        raise KeyError(f"bvh_from_numpy: missing columns {missing}")
    a = {f: np.asarray(arrays[f]) for f in fields}
    return bvh_from_arrays(
        np.stack([a["bmin_x"], a["bmin_y"], a["bmin_z"]], -1),
        np.stack([a["bmax_x"], a["bmax_y"], a["bmax_z"]], -1),
        a["miss_link"], a["leaf_first"], a["leaf_count"],
        resolve_device(device))
