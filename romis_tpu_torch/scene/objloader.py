"""Wavefront OBJ/MTL loader, numpy only (reference
``romis_tpu/scene/objloader.py``, the same contract):

- shapes are split into submeshes by material run,
- missing vertex normals fall back to the geometric (face) normal,
- a missing material gives kd = (1, 1, 1), ks = 0, shininess = 1,
- optional center-and-scale-to-unit-sphere normalisation over all
  submeshes jointly,
- out-of-range texcoord/normal indices are treated as absent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Material:
    name: str = ""
    kd: tuple = (1.0, 1.0, 1.0)
    ks: tuple = (0.0, 0.0, 0.0)
    shininess: float = 1.0
    transparency: float = 1.0
    kd_texture: str | None = None  # path to texture image, if any


@dataclass
class SubMesh:
    """One material-homogeneous triangle soup."""

    positions: np.ndarray  # [V, 3] float32
    normals: np.ndarray  # [V, 3] float32 (unit)
    texcoords: np.ndarray  # [V, 2] float32
    triangles: np.ndarray  # [T, 3] int32 vertex indices
    material: Material = field(default_factory=Material)


def _parse_mtl(path: str) -> dict[str, Material]:
    materials: dict[str, Material] = {}
    cur: Material | None = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = Material(name=parts[1] if len(parts) > 1 else "")
                materials[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur.kd = tuple(float(v) for v in parts[1:4])
            elif key == "Ks":
                cur.ks = tuple(float(v) for v in parts[1:4])
            elif key == "Ns":
                cur.shininess = float(parts[1])
            elif key == "d":
                cur.transparency = float(parts[1])
            elif key == "map_Kd":
                cur.kd_texture = os.path.join(os.path.dirname(path), parts[-1])
    return materials


def _parse_face_vertex(token: str):
    """An OBJ face vertex `v`, `v/vt`, `v//vn` or `v/vt/vn` → (v, vt, vn),
    each an OBJ index or None."""
    fields = token.split("/")
    v = int(fields[0])
    vt = int(fields[1]) if len(fields) > 1 and fields[1] else None
    vn = int(fields[2]) if len(fields) > 2 and fields[2] else None
    return v, vt, vn


def load_obj(path: str, center_and_normalize: bool = False) -> list[SubMesh]:
    """Load an OBJ file into material-split submeshes."""
    positions: list[list[float]] = []
    normals: list[list[float]] = []
    texcoords: list[list[float]] = []
    runs: list[tuple[str | None, list]] = []  # (material, triangles)
    materials: dict[str, Material] = {}
    cur_mtl: str | None = None

    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                texcoords.append([float(x) for x in parts[1:3]])
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(parts[1:]))
                materials.update(_parse_mtl(mtl_path))
            elif key == "usemtl":
                cur_mtl = parts[1] if len(parts) > 1 else None
            elif key == "f":
                verts = [_parse_face_vertex(tok) for tok in parts[1:]]
                # Fan triangulation (OBJ polygons are convex by convention).
                tris = [
                    (verts[0], verts[i], verts[i + 1])
                    for i in range(1, len(verts) - 1)
                ]
                if runs and runs[-1][0] == cur_mtl:
                    runs[-1][1].extend(tris)
                else:
                    runs.append((cur_mtl, list(tris)))

    pos_arr = np.asarray(positions, np.float32).reshape(-1, 3)
    nrm_arr = np.asarray(normals, np.float32).reshape(-1, 3)
    uv_arr = np.asarray(texcoords, np.float32).reshape(-1, 2)

    def resolve(idx: int | None, count: int) -> int | None:
        """OBJ indices are 1-based; negative = relative; out-of-range →
        absent."""
        if idx is None:
            return None
        i = idx - 1 if idx > 0 else count + idx
        return i if 0 <= i < count else None

    out: list[SubMesh] = []
    for mtl_name, tris in runs:
        if not tris:
            continue
        vert_cache: dict[tuple, int] = {}
        v_pos: list = []
        v_nrm: list = []
        v_uv: list = []
        tri_idx: list[list[int]] = []
        for tri in tris:
            p = [pos_arr[resolve(v[0], len(pos_arr))] for v in tri]
            gn = np.cross(p[1] - p[0], p[2] - p[0])
            n = np.linalg.norm(gn)
            gn = gn / n if n > 0 else np.array([0.0, 1.0, 0.0], np.float32)
            idx3 = []
            for vi, vti, vni in tri:
                pi = resolve(vi, len(pos_arr))
                ni = resolve(vni, len(nrm_arr))
                ti = resolve(vti, len(uv_arr))
                nrm = nrm_arr[ni] if ni is not None else gn
                uv = uv_arr[ti] if ti is not None else np.zeros(2, np.float32)
                keyt = (pi, ni, ti,
                        None if ni is not None else tuple(np.round(gn, 6)))
                if keyt in vert_cache:
                    idx3.append(vert_cache[keyt])
                else:
                    vert_cache[keyt] = len(v_pos)
                    idx3.append(len(v_pos))
                    v_pos.append(pos_arr[pi])
                    v_nrm.append(np.asarray(nrm, np.float32))
                    v_uv.append(np.asarray(uv, np.float32))
            tri_idx.append(idx3)

        mat = materials.get(mtl_name, None)
        if mat is None:
            mat = Material()
        out.append(
            SubMesh(
                positions=np.asarray(v_pos, np.float32).reshape(-1, 3),
                normals=np.asarray(v_nrm, np.float32).reshape(-1, 3),
                texcoords=np.asarray(v_uv, np.float32).reshape(-1, 2),
                triangles=np.asarray(tri_idx, np.int32).reshape(-1, 3),
                material=mat,
            )
        )

    if center_and_normalize and out:
        all_pos = np.concatenate([m.positions for m in out], axis=0)
        center = all_pos.mean(axis=0)
        max_d = np.max(np.linalg.norm(all_pos - center, axis=-1))
        for m in out:
            m.positions = (m.positions - center) / max_d

    return out


def write_obj(path: str, submeshes: list[SubMesh]) -> None:
    """Write submeshes as an OBJ file and its MTL beside it (``<stem>.mtl``),
    one material per submesh, so that ``load_obj`` gives them back: the
    same submeshes, positions, normals and texcoords to the float32 bit
    (9 significant digits)."""
    stem = os.path.splitext(path)[0]
    mtl = stem + ".mtl"
    with open(mtl, "w") as f:
        for i, sm in enumerate(submeshes):
            m = sm.material
            f.write(f"newmtl m{i}\n"
                    f"Kd {' '.join(f'{v:.9g}' for v in m.kd)}\n"
                    f"Ks {' '.join(f'{v:.9g}' for v in m.ks)}\n"
                    f"Ns {m.shininess:.9g}\nd {m.transparency:.9g}\n")
    lines = [f"mtllib {os.path.basename(mtl)}\n"]
    base = 1
    for i, sm in enumerate(submeshes):
        lines += [f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in sm.positions]
        lines += [f"vn {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in sm.normals]
        lines += [f"vt {u:.9g} {v:.9g}\n" for u, v in sm.texcoords]
        lines.append(f"usemtl m{i}\n")
        lines += ["f " + " ".join(f"{base + j}/{base + j}/{base + j}"
                                  for j in tri) + "\n"
                  for tri in sm.triangles]
        base += len(sm.positions)
    with open(path, "w") as f:
        f.writelines(lines)
