"""The program's scene and camera, built from a configuration's arrays
(``scenedata``) through the program's own scene API: one submesh a
published surface, so the program's geometry id is the surface's."""

from __future__ import annotations

import numpy as np

from .scenedata import load


def build(config: dict, device, size=None):
    """→ (scene, camera, height, width) of ``romis_tpu_torch``."""
    from romis_tpu_torch.core.camera import make_camera
    from romis_tpu_torch.scene.lights import LightListBuilder
    from romis_tpu_torch.scene.objloader import Material, SubMesh
    from romis_tpu_torch.scene.scene import Scene, build_geometry

    d = load(config, size)
    meshes = []
    for gi in range(int(d.geometry.max()) + 1):
        sel = np.flatnonzero(d.geometry == gi)
        m = int(d.material[sel[0]])
        if (d.material[sel] != m).any() or np.diff(sel).max(initial=1) != 1:
            raise ValueError(f"{config['name']}: a surface's quads must be "
                             "listed together and share one material")
        meshes.append(SubMesh(
            positions=d.tris[sel].reshape(-1, 3),
            normals=np.repeat(d.normals[sel], 3, axis=0),
            texcoords=np.zeros((3 * len(sel), 2), np.float32),
            triangles=np.arange(3 * len(sel), dtype=np.int32).reshape(-1, 3),
            material=Material(kd=tuple(d.kd[m]), ks=tuple(d.ks[m]),
                              shininess=float(d.shininess[m]))))
    b = LightListBuilder()
    for row in d.lights:
        b.add_parallelogram(*row)
    scene = Scene(geometry=build_geometry(meshes, device),
                  lights=b.build(device), num_lights=len(b),
                  name=config["name"])
    cam = make_camera(look_at=d.look_at, rotation_deg=d.rotation_deg,
                      distance=d.distance, fov_deg=d.fov_y_deg,
                      resolution=(d.height, d.width), device=device)
    return scene, cam, d.height, d.width
