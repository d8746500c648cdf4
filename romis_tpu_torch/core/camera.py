"""Orbit camera and primary-ray generation (reference
``romis_tpu/core/camera.py``): the glm XYZ Euler quaternion, camera position
``look_at + R * (0, 0, -distance)``, and rays through NDC pixel coordinates
in display order (row 0 = image top)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import stats
from .device import resolve_device
from .types import Rays
from .vec import vcross, vnormalize


@dataclass
class CameraParams:
    look_at: torch.Tensor  # [3]
    rotation: torch.Tensor  # [3] Euler (x, y, z), radians
    distance: torch.Tensor  # []
    fovy: torch.Tensor  # [] vertical field of view, radians
    aspect: torch.Tensor  # [] width / height


def make_camera(look_at=(0.0, 0.0, 0.0), rotation_deg=(20.0, 20.0, 0.0),
                distance=3.0, fov_deg=50.0, resolution=(256, 256),
                device=None) -> CameraParams:
    """Camera parameters on ``device`` (default: the CUDA device)."""
    height, width = resolution
    device = resolve_device(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return CameraParams(
        look_at=f32(look_at),
        rotation=torch.deg2rad(f32(rotation_deg)),
        distance=f32(distance),
        fovy=torch.deg2rad(f32(fov_deg)),
        aspect=f32(width / height),
    )


def quat_from_euler_xyz(euler: torch.Tensor) -> torch.Tensor:
    """glm::quat(glm::vec3 euler) → [w, x, y, z]."""
    half = euler * 0.5
    c = torch.cos(half)
    s = torch.sin(half)
    w = c[0] * c[1] * c[2] + s[0] * s[1] * s[2]
    x = s[0] * c[1] * c[2] - c[0] * s[1] * s[2]
    y = c[0] * s[1] * c[2] + s[0] * c[1] * s[2]
    z = c[0] * c[1] * s[2] - s[0] * s[1] * c[2]
    return torch.stack([w, x, y, z])


def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate one [3] vector by quaternion q [w, x, y, z]."""
    qv = q[1:]
    t = 2.0 * _cross3(qv, v)
    return v + q[0] * t + _cross3(qv, t)


def quat_rotate_imgminor(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate image-minor vectors [..., 3, H, W] by quaternion q."""
    qv = q[1:][:, None, None].expand(v.shape)
    t = 2.0 * vcross(qv, v)
    return v + q[0] * t + vcross(qv, t)


def camera_position(cam: CameraParams) -> torch.Tensor:
    q = quat_from_euler_xyz(cam.rotation)
    # A copy from pageable host memory: on a CUDA device the host waits for
    # the device's queue to drain first (the span romis.sync.camera).
    with stats.span(stats.SYNC + "camera"):
        back = torch.tensor([0.0, 0.0, -1.0], device=cam.look_at.device)
    return cam.look_at + quat_rotate(q, back * cam.distance)


def generate_rays(cam: CameraParams, height: int, width: int) -> Rays:
    """Primary rays [3, H, W] on the camera's device."""
    device = cam.look_at.device
    q = quat_from_euler_xyz(cam.rotation)
    origin = camera_position(cam)

    half_h = torch.tan(cam.fovy * 0.5)
    half_w = cam.aspect * half_h

    xs = torch.arange(width, dtype=torch.float32, device=device) / width \
        * 2.0 - 1.0
    ys = (height - 1 - torch.arange(height, dtype=torch.float32,
                                    device=device)) / height * 2.0 - 1.0
    px = xs[None, :].expand(height, width)
    py = ys[:, None].expand(height, width)
    dirs_cam = torch.stack([-px * half_w, py * half_h, torch.ones_like(px)])
    dirs = quat_rotate_imgminor(q, vnormalize(dirs_cam))
    origins = origin[:, None, None].expand(dirs.shape).contiguous()
    return Rays(origin=origins, direction=dirs.contiguous())


def project_to_pixel(cam: CameraParams, points: torch.Tensor, height: int,
                     width: int):
    """Project world points [..., 3, H, W] back to (row, col) pixel
    coordinates under ``cam``, the inverse of ``generate_rays``, for temporal
    reprojection → (rows, cols float32, in_front bool), each [..., H, W]."""
    q = quat_from_euler_xyz(cam.rotation)
    origin = camera_position(cam)
    q_inv = q * torch.tensor([1.0, -1.0, -1.0, -1.0], device=q.device)
    v_cam = quat_rotate_imgminor(q_inv, points - origin[:, None, None])

    half_h = torch.tan(cam.fovy * 0.5)
    half_w = cam.aspect * half_h
    z = v_cam[..., 2, :, :]
    in_front = z > 1e-6
    zs = torch.where(in_front, z, 1.0)
    px = -(v_cam[..., 0, :, :] / zs) / half_w
    py = (v_cam[..., 1, :, :] / zs) / half_h
    col = (px + 1.0) * 0.5 * width
    row = (height - 1) - (py + 1.0) * 0.5 * height
    return row, col, in_front
