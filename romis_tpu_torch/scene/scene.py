"""Flat triangle-soup scene (reference ``romis_tpu/scene/scene.py``).

All submeshes are fused into one soup with per-triangle material and
submesh ids, padded to a multiple of ``TRI_PAD`` with inactive zero-area
triangles. The tables are built with numpy and placed on the given device
as tensors. Packed row tables:

    tri_cols  [10, T]: v0 xyz | e1 xyz | e2 xyz | active    (kernel layout)
    attr_rows [T, 24]: n0 n1 n2 (9) | uv0 uv1 uv2 (6) | mat_id | geom_id | pad(7)
    mat_rows  [M, 8]:  kd(3) | ks(3) | shininess | tex_id

``repack_rows`` builds them from the columns with ``torch.cat``, so they
are differentiable in the columns (``diff.grad.apply_params`` relies on
this); the kernels read them as plain contiguous tables.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from romis_tpu.scene.objloader import Material, SubMesh

from .lights import LightListBuilder, LightTable, regular_light_grid

TRI_PAD = 8

# Geometry columns carried between the packages (convert.py) — the packed
# tables are rebuilt from them.
COLUMNS = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_id",
           "geom_id", "active", "mat_kd", "mat_ks", "mat_shininess",
           "mat_tex_id", "tex_data", "tex_size")


@dataclass
class Geometry:
    v0: torch.Tensor  # [T, 3]
    e1: torch.Tensor  # [T, 3] v1 - v0
    e2: torch.Tensor  # [T, 3] v2 - v0
    n0: torch.Tensor  # [T, 3] per-vertex shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # [T, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor  # [T] int32
    geom_id: torch.Tensor  # [T] int32
    active: torch.Tensor  # [T] bool (False on padding)
    mat_kd: torch.Tensor  # [M, 3]
    mat_ks: torch.Tensor  # [M, 3]
    mat_shininess: torch.Tensor  # [M]
    mat_tex_id: torch.Tensor  # [M] int32, -1 = no texture
    tex_data: torch.Tensor  # [NT, TH, TW, 3]
    tex_size: torch.Tensor  # [NT, 2] int32 (height, width)
    tri_cols: torch.Tensor  # [10, T]
    attr_rows: torch.Tensor  # [T, 24]
    mat_rows: torch.Tensor  # [M, 8]

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device


@dataclass
class Scene:
    geometry: Geometry
    lights: LightTable
    num_lights: int
    name: str = "scene"


def pack_tri_cols(v0, e1, e2, active) -> torch.Tensor:
    """[T, 3] x 3 and [T] bool → the kernel layout [10, T]."""
    return torch.cat([v0.t(), e1.t(), e2.t(), active.float()[None]], dim=0)


def pack_attr_rows(n0, n1, n2, uv0, uv1, uv2, mat_id, geom_id) -> torch.Tensor:
    n = n0.shape[0]
    return torch.cat([n0, n1, n2, uv0, uv1, uv2, mat_id.float()[:, None],
                      geom_id.float()[:, None],
                      torch.zeros((n, 7), device=n0.device)], dim=1)


def pack_mat_rows(mat_kd, mat_ks, mat_shininess, mat_tex_id) -> torch.Tensor:
    return torch.cat([mat_kd, mat_ks, mat_shininess[:, None],
                      mat_tex_id.float()[:, None]], dim=1)


def repack_rows(g: Geometry) -> Geometry:
    """(Re)build the packed tables from the component columns (reference
    ``scene/scene.repack_rows``); call it after replacing any column."""
    return replace(
        g, tri_cols=pack_tri_cols(g.v0, g.e1, g.e2, g.active),
        attr_rows=pack_attr_rows(g.n0, g.n1, g.n2, g.uv0, g.uv1, g.uv2,
                                 g.mat_id, g.geom_id),
        mat_rows=pack_mat_rows(g.mat_kd, g.mat_ks, g.mat_shininess,
                               g.mat_tex_id))


def geometry_from_arrays(a: dict, device="cpu") -> Geometry:
    """Geometry from numpy columns (``COLUMNS``); packs the row tables."""
    ints = ("mat_id", "geom_id", "mat_tex_id", "tex_size")

    def t(k):
        x = np.asarray(a[k])
        if k == "active":
            return torch.as_tensor(x.astype(bool), device=device)
        dtype = torch.int32 if k in ints else torch.float32
        return torch.as_tensor(np.array(x, order="C"), dtype=dtype,
                               device=device)

    cols = {k: t(k) for k in COLUMNS}
    return repack_rows(Geometry(**cols, tri_cols=None, attr_rows=None,
                                mat_rows=None))


def _load_texture(path: str) -> np.ndarray | None:
    try:
        from PIL import Image

        img = Image.open(path).convert("RGB")
        return np.asarray(img, np.float32) / 255.0
    except (ImportError, OSError):
        return None


def geometry_arrays(submeshes: list[SubMesh]) -> dict:
    """Fuse submeshes into the flat soup as numpy columns (``COLUMNS``)."""
    tris = []
    mats = []
    textures: list[np.ndarray] = []
    tex_paths: dict[str, int] = {}

    for gid, sm in enumerate(submeshes):
        m = sm.material
        tex_id = -1
        if m.kd_texture:
            if m.kd_texture not in tex_paths:
                img = _load_texture(m.kd_texture)
                tex_paths[m.kd_texture] = len(textures) if img is not None \
                    else -1
                if img is not None:
                    textures.append(img)
            tex_id = tex_paths[m.kd_texture]
        mats.append((m.kd, m.ks, m.shininess, tex_id))
        mat_id = len(mats) - 1
        p, nrm, uv = sm.positions, sm.normals, sm.texcoords
        for tri in sm.triangles:
            i0, i1, i2 = int(tri[0]), int(tri[1]), int(tri[2])
            tris.append((p[i0], p[i1] - p[i0], p[i2] - p[i0],
                         nrm[i0], nrm[i1], nrm[i2],
                         uv[i0], uv[i1], uv[i2], mat_id, gid))

    n_tris = len(tris)
    n_pad = max(TRI_PAD, -(-n_tris // TRI_PAD) * TRI_PAD)

    def col(i, dim):
        a = np.zeros((n_pad, dim), np.float32)
        if n_tris:
            a[:n_tris] = np.asarray([r[i] for r in tris], np.float32)
        return a

    def ids(i):
        a = np.zeros((n_pad,), np.int32)
        if n_tris:
            a[:n_tris] = [r[i] for r in tris]
        return a

    if textures:
        th = max(x.shape[0] for x in textures)
        tw = max(x.shape[1] for x in textures)
        tex = np.zeros((len(textures), th, tw, 3), np.float32)
        sizes = np.zeros((len(textures), 2), np.int32)
        for i, x in enumerate(textures):
            tex[i, :x.shape[0], :x.shape[1]] = x
            sizes[i] = (x.shape[0], x.shape[1])
    else:
        tex = np.zeros((1, 1, 1, 3), np.float32)
        sizes = np.ones((1, 2), np.int32)

    active = np.zeros((n_pad,), bool)
    active[:n_tris] = True
    names = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2")
    dims = (3, 3, 3, 3, 3, 3, 2, 2, 2)
    out = {k: col(i, d) for i, (k, d) in enumerate(zip(names, dims))}
    out.update(
        mat_id=ids(9), geom_id=ids(10), active=active,
        mat_kd=np.asarray([m[0] for m in mats], np.float32).reshape(-1, 3),
        mat_ks=np.asarray([m[1] for m in mats], np.float32).reshape(-1, 3),
        mat_shininess=np.asarray([m[2] for m in mats],
                                 np.float32).reshape(-1),
        mat_tex_id=np.asarray([m[3] for m in mats], np.int32).reshape(-1),
        tex_data=tex, tex_size=sizes,
    )
    return out


def build_geometry(submeshes: list[SubMesh], device="cpu") -> Geometry:
    return geometry_from_arrays(geometry_arrays(submeshes), device)


def nightclub_lights(builder: LightListBuilder) -> LightListBuilder:
    """The Cornell Nightclub's 512 wall lights (reference
    constructNightClubLights)."""
    counts = (16, 16)
    free = 0.30
    regular_light_grid(builder, (-8.7, 6.4, -9.1), counts,
                       (0.0, 0.0, 17.0), (0.0, -6.0, 0.0),
                       (0.65, 0.65, 0.65), free)
    regular_light_grid(builder, (9.2, 6.4, 8.6), counts,
                       (-17.0, 0.0, 0.0), (0.0, -6.0, 0.0),
                       (0.4, 0.4, 0.4), free)
    return builder


def flagship_scene(device="cpu") -> Scene:
    """The procedural stand-in for the Cornell Nightclub: a 20x20 ground quad
    (2 triangles) under two 16x16 grids of area lights (512 lights) — the
    scene the reference's flagship benchmark renders when the OBJ assets are
    absent."""
    quad = SubMesh(
        positions=np.array([[-10, 0, -10], [10, 0, -10], [10, 0, 10],
                            [-10, 0, 10]], np.float32),
        normals=np.tile(np.array([0, 1, 0], np.float32), (4, 1)),
        texcoords=np.zeros((4, 2), np.float32),
        triangles=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        material=Material(kd=(0.7, 0.7, 0.7)),
    )
    b = LightListBuilder()
    regular_light_grid(b, (-8, 6, -8), (16, 16), (16, 0, 0), (0, 0, 16),
                       (0.5, 0.5, 0.5), 0.3)
    regular_light_grid(b, (-8, 8, -8), (16, 16), (16, 0, 0), (0, 0, 16),
                       (0.4, 0.4, 0.4), 0.3)
    return Scene(geometry=build_geometry([quad], device),
                 lights=b.build(device), num_lights=len(b),
                 name="procedural_nightclub")


def flagship_camera(height: int, width: int, device="cpu"):
    """The reference camera defaults (CameraConfig) used with the flagship
    scene."""
    from ..core.camera import make_camera

    return make_camera(look_at=(2.57, 1.23, -1.35),
                       rotation_deg=(10.3, 30.0, 0.0), distance=25.0,
                       fov_deg=30.0, resolution=(height, width),
                       device=device)
