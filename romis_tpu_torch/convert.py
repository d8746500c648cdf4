"""Carry a scene, a camera and scene parameters over from the JAX package.

The caller extracts the reference's arrays with ``np.asarray``; these
functions build the port's objects from them. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import CameraParams
from .scene.lights import COLUMNS as LIGHT_COLUMNS, light_table_from_arrays
from .scene.scene import COLUMNS as GEOMETRY_COLUMNS, Scene, geometry_from_arrays


def scene_from_numpy(geometry: dict[str, np.ndarray],
                     lights: dict[str, np.ndarray], num_lights: int,
                     device="cpu", name: str = "scene") -> Scene:
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
                      device="cpu") -> CameraParams:
    """The reference CameraParams' fields (rotation and fovy in radians)."""
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return CameraParams(look_at=f32(look_at), rotation=f32(rotation),
                        distance=f32(distance), fovy=f32(fovy),
                        aspect=f32(aspect))


def params_from_numpy(params: dict[str, np.ndarray], device="cpu"):
    """The reference SceneParams' 13 leaves (``diff.grad.SceneParams``
    field names) → the port's SceneParams."""
    from .diff.grad import SceneParams

    return SceneParams(**{
        f: torch.as_tensor(np.array(params[f], np.float32), device=device)
        for f in SceneParams.__dataclass_fields__})
