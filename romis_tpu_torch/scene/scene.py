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

Procedural scenes: ``flagship_scene`` (the Cornell Nightclub's stand-in)
and ``torus_field`` (the large scene, 24,202 triangles at n = 5, the
stand-in for the reference's monkey field; render it through a BVH,
``ops.bvh.with_bvh``). Scenes from OBJ files: ``load_prebuilt`` (the
reference's named scenes with their lights, from the data directory),
``load_scene_from_file`` and ``load_monkey_field``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.device import resolve_device
from .objloader import Material, SubMesh, load_obj

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
    # Optional acceleration structure (ops/bvh.BVH, attached by
    # ops.bvh.with_bvh): every trace entry point then walks the tree
    # instead of scanning the soup.
    bvh: object = None
    # The soup's blocks (ops.trace.soup_blocks) of kernels 7, 4 and 1, built
    # at the first call that culls and kept with the columns tensor they
    # came from.
    zcount: object = dataclasses.field(default=None, repr=False,
                                       compare=False)
    # Kernel 8's constants in the blocks' order and its guard
    # (ops.trace.plucker_blocks), kept the same way.
    plucker: object = dataclasses.field(default=None, repr=False,
                                        compare=False)
    # Kernel 18's leaf-triangle records (ops.walk.kept_records), kept the
    # same way.
    records: object = dataclasses.field(default=None, repr=False,
                                        compare=False)

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


def geometry_from_arrays(a: dict, device=None) -> Geometry:
    """Geometry from numpy columns (``COLUMNS``) on ``device`` (default:
    the CUDA device, ``core.device``); packs the row tables."""
    device = resolve_device(device)
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


def build_geometry(submeshes: list[SubMesh], device=None) -> Geometry:
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


def flagship_scene(device=None) -> Scene:
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


TORUS_SEGMENTS = 22  # 22 x 22 quads: 968 triangles per torus
TORUS_RADII = (1.0, 0.4)  # ring, tube
TORUS_TILT_DEG = 45.0  # about X, so that each torus shadows itself
FIELD_SPACING = 2.2  # the reference's _instance_grid spacing


def torus_mesh():
    """The field's torus, TORUS_SEGMENTS² quads, as numpy arrays
    (positions [V, 3], normals [V, 3], texcoords [V, 2], triangles [T, 3]
    int32), centred and scaled into the unit ball as the OBJ loader's
    ``center_and_normalize`` scales, then tilted about X."""
    segments, (major, minor) = TORUS_SEGMENTS, TORUS_RADII
    a = 2.0 * np.pi * np.arange(segments) / segments
    u, v = np.meshgrid(a, a, indexing="ij")  # around the axis, the tube
    ring = major + minor * np.cos(v)
    pos = np.stack([ring * np.cos(u), minor * np.sin(v), ring * np.sin(u)],
                   -1).reshape(-1, 3)
    nrm = np.stack([np.cos(v) * np.cos(u), np.sin(v), np.cos(v) * np.sin(u)],
                   -1).reshape(-1, 3)
    pos = pos - pos.mean(axis=0)
    pos = pos / np.max(np.linalg.norm(pos, axis=-1))
    c, s = np.cos(np.radians(TORUS_TILT_DEG)), np.sin(np.radians(
        TORUS_TILT_DEG))
    rot = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
    i, j = np.meshgrid(np.arange(segments), np.arange(segments),
                       indexing="ij")
    i1, j1 = (i + 1) % segments, (j + 1) % segments
    q00, q10 = i * segments + j, i1 * segments + j
    q01, q11 = i * segments + j1, i1 * segments + j1
    tris = np.stack([np.stack([q00, q01, q11], -1),
                     np.stack([q00, q11, q10], -1)], 2).reshape(-1, 3)
    uv = np.stack([u, v], -1).reshape(-1, 2) / (2.0 * np.pi)
    return ((pos @ rot.T).astype(np.float32),
            (nrm @ rot.T).astype(np.float32), uv.astype(np.float32),
            tris.astype(np.int32))


def torus_field_submeshes(n: int = 5) -> list[SubMesh]:
    """The n x n torus field's submeshes: one torus per cell of the
    reference ``_instance_grid`` (spacing 2.2 on the XZ plane), then the
    ground quad under the grid, which shares the torus material as the
    monkey field's quad shares the monkey's."""
    pos, nrm, uv, tris = torus_mesh()
    mat = Material(kd=(0.75, 0.55, 0.35), ks=(0.25, 0.25, 0.25),
                   shininess=32.0)
    half = (n - 1) / 2.0
    out = []
    for gi in range(n):
        for gj in range(n):
            off = np.asarray([(gi - half) * FIELD_SPACING, 0.0,
                              (gj - half) * FIELD_SPACING], np.float32)
            out.append(SubMesh(positions=pos + off, normals=nrm,
                               texcoords=uv, triangles=tris, material=mat))
    ext = 1.4 * n
    out.append(SubMesh(
        positions=np.asarray([[-ext, -0.8, -ext], [ext, -0.8, -ext],
                              [ext, -0.8, ext], [-ext, -0.8, ext]],
                             np.float32),
        normals=np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1)),
        texcoords=np.zeros((4, 2), np.float32),
        triangles=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        material=mat))
    return out


def torus_field_lights(builder: LightListBuilder,
                       n: int = 5) -> LightListBuilder:
    """The monkey field's lights: a parallelogram sky light of radiance 40
    above the grid and two point lights at opposite corners."""
    ext = 1.4 * n
    b = builder
    b.add_parallelogram((-0.3 * n, 1.5 * n, -0.3 * n), (0.6 * n, 0, 0),
                        (0, 0, 0.6 * n), (40.0, 40.0, 40.0),
                        (40.0, 40.0, 40.0), (40.0, 40.0, 40.0),
                        (40.0, 40.0, 40.0))
    b.add_point((-ext, 2.0, -ext), (30, 30, 30))
    b.add_point((ext, 2.0, ext), (30, 30, 30))
    return b


def torus_field(n: int = 5, device=None) -> Scene:
    """The procedural large scene: an n x n field of tori (968 triangles
    each) on a ground quad, n·n·968 + 2 triangles (24,202 at n = 5, the
    reference's monkey field's count), lit as ``load_monkey_field`` lights
    its field. It stands in for the monkey field, whose OBJ asset is not in
    the repository; attach a BVH with ``ops.bvh.with_bvh``."""
    b = torus_field_lights(LightListBuilder(), n)
    return Scene(geometry=build_geometry(torus_field_submeshes(n), device),
                 lights=b.build(device), num_lights=len(b),
                 name=f"torus_field_{n}x{n}")


def torus_field_camera(height: int, width: int, device=None):
    """The large-scene camera of the reference's bench.py config 6."""
    from ..core.camera import make_camera

    return make_camera(look_at=(0, 0, 0), rotation_deg=(25, 30, 0),
                       distance=11.0, fov_deg=50, resolution=(height, width),
                       device=device)


def flagship_camera(height: int, width: int, device=None):
    """The reference camera defaults (CameraConfig) used with the flagship
    scene."""
    from ..core.camera import make_camera

    return make_camera(look_at=(2.57, 1.23, -1.35),
                       rotation_deg=(10.3, 30.0, 0.0), distance=25.0,
                       fov_deg=30.0, resolution=(height, width),
                       device=device)


# ---------------------------------------------------------------------------
# Scenes from OBJ files (reference ``romis_tpu/scene/scene.py:255-388``)
# ---------------------------------------------------------------------------

def default_data_dir() -> str | None:
    """The directory of the OBJ assets: ``ROMIS_DATA_DIR``, else ``data/``
    at the repository root, where it exists."""
    for cand in (os.environ.get("ROMIS_DATA_DIR"),
                 os.path.join(os.path.dirname(__file__), "..", "..", "data")):
        if cand and os.path.isdir(cand):
            return cand
    return None


# Name → (OBJ file, center and normalize), reference loadScenePrebuilt.
_PREBUILT = {
    "single_triangle": ("triangle.obj", False),
    "cube": ("cube.obj", False),
    "cube_textured": ("cube-textured.obj", False),
    "cornell_box": ("CornellBox-Mirror-Rotated.obj", True),
    "cornell_box_parallelogram_light": ("CornellBox-Mirror-Rotated.obj", True),
    "cornell_nightclub": ("cornell-nightclub.obj", False),
    "monkey": ("monkey.obj", True),
}


def _instance_grid(submeshes: list[SubMesh], n: int,
                   spacing: float = FIELD_SPACING) -> list[SubMesh]:
    """The submeshes replicated over an n x n grid on the XZ plane."""
    out = []
    half = (n - 1) / 2.0
    for gi in range(n):
        for gj in range(n):
            off = np.asarray([(gi - half) * spacing, 0.0,
                              (gj - half) * spacing], np.float32)
            for sm in submeshes:
                out.append(dataclasses.replace(sm,
                                               positions=sm.positions + off))
    return out


def _data_dir(data_dir: str | None) -> str:
    data_dir = data_dir or default_data_dir()
    if data_dir is None:
        raise FileNotFoundError("no data directory found; set ROMIS_DATA_DIR")
    return data_dir


def load_monkey_field(n: int = 5, data_dir: str | None = None,
                      device=None) -> Scene:
    """An n x n grid of monkeys (n·n·500 + 2 triangles) on a ground quad,
    under a parallelogram sky light and 2 point lights: the reference's
    large-scene workload (render it through a BVH, ``ops.bvh.with_bvh``)."""
    submeshes = load_obj(os.path.join(_data_dir(data_dir), "monkey.obj"),
                         center_and_normalize=True)
    submeshes = _instance_grid(submeshes, n)
    ext = 1.4 * n
    submeshes.append(dataclasses.replace(
        submeshes[0],
        positions=np.asarray([[-ext, -0.8, -ext], [ext, -0.8, -ext],
                              [ext, -0.8, ext], [-ext, -0.8, ext]],
                             np.float32),
        normals=np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1)),
        texcoords=np.zeros((4, 2), np.float32),
        triangles=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)))
    lights = torus_field_lights(LightListBuilder(), n)
    return Scene(geometry=build_geometry(submeshes, device),
                 lights=lights.build(device), num_lights=len(lights),
                 name=f"monkey_field_{n}x{n}")


def load_prebuilt(name: str, data_dir: str | None = None,
                  device=None) -> Scene:
    """A reference scene by name (reference loadScenePrebuilt,
    src/scene/scene.cpp:68-132) with its hard-coded lights."""
    obj, center = _PREBUILT[name]
    submeshes = load_obj(os.path.join(_data_dir(data_dir), obj),
                         center_and_normalize=center)
    lights = LightListBuilder()
    if name == "single_triangle":
        submeshes[0].material.kd = (1.0, 1.0, 1.0)  # as the reference does
        lights.add_point((-1, 1, -1), (1, 1, 1))
    elif name == "cube":
        lights.add_segment((1.5, 0.5, -0.6), (-1, 0.5, -0.5),
                           (0.9, 0.2, 0.1), (0.2, 1, 0.3))
    elif name == "cube_textured":
        lights.add_point((-1.0, 1.5, -1.0), (1, 1, 1))
    elif name == "cornell_box":
        lights.add_point((0, 0.58, 0), (1, 1, 1))
    elif name == "cornell_box_parallelogram_light":
        lights.add_parallelogram(
            (-0.2, 0.5, 0), (0.4, 0, 0), (0.0, 0.0, 0.4),
            (1.0, 1.0, 1.0), (0.5, 0.5, 0.5), (0.5, 0.5, 0.5), (1.0, 1.0, 1.0))
    elif name == "cornell_nightclub":
        nightclub_lights(lights)
    elif name == "monkey":
        lights.add_point((-1, 1, -1), (1, 1, 1))
        lights.add_point((1, -1, -1), (1, 1, 1))
    return Scene(geometry=build_geometry(submeshes, device),
                 lights=lights.build(device), num_lights=len(lights),
                 name=name)


def load_scene_from_file(path: str, lights: LightListBuilder,
                         center_and_normalize: bool = False,
                         device=None) -> Scene:
    """An OBJ file under the given lights (reference loadSceneFromFile,
    src/scene/scene.cpp:134-140)."""
    submeshes = load_obj(path, center_and_normalize=center_and_normalize)
    return Scene(geometry=build_geometry(submeshes, device),
                 lights=lights.build(device), num_lights=len(lights),
                 name=os.path.splitext(os.path.basename(path))[0])
