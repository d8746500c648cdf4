"""A configuration's scene as plain arrays, the input both sides take.

The configuration file holds the scene as published: quads (four corners
each), the surface (object) and material of each, the points its normals
face toward or away from, the parallelogram lights and the camera.
``load`` turns it into float32 arrays once, so the program and the
reference start from the same numbers: each quad split along its diagonal
from the first corner to the third, every triangle with its own three
vertices and its flat normal.
Nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class SceneData:
    tris: np.ndarray  # [T, 3 vertices, 3] float32
    normals: np.ndarray  # [T, 3] float32, unit
    material: np.ndarray  # [T] int32, an index into the tables below
    geometry: np.ndarray  # [T] int32, the published surface it lies on
    kd: np.ndarray  # [M, 3] float32
    ks: np.ndarray  # [M, 3] float32
    shininess: np.ndarray  # [M] float32
    lights: np.ndarray  # [L, 7, 3] float32: corner, edge01, edge02, c0..c3
    look_at: tuple
    rotation_deg: tuple
    distance: float
    fov_y_deg: float
    height: int
    width: int


def _facing(quad: dict, config: dict) -> tuple[np.ndarray, float]:
    """The point a quad's normals are turned by, and the sign: +1 toward
    the room's centre, -1 away from a solid's centre."""
    if quad["faces"] == "room":
        return np.asarray(config["room_centre"], np.float64), 1.0
    return np.asarray(config["solids"][quad["faces"]], np.float64), -1.0


def load(config: dict, size=None) -> SceneData:
    """``size`` (height, width) replaces the configuration's."""
    scale = float(config["scale"])
    names = list(config["materials"])
    objects = list(dict.fromkeys(q["object"] for q in config["quads"]))
    tris, normals, material, geometry = [], [], [], []
    for quad in config["quads"]:
        c = np.asarray(quad["corners"], np.float64)
        point, sign = _facing(quad, config)
        for a, b, d in ((0, 1, 2), (0, 2, 3)):
            n = np.cross(c[b] - c[a], c[d] - c[a])
            n /= np.linalg.norm(n)
            if sign * np.dot(point - c[a], n) < 0:
                n = -n
            tris.append(np.stack([c[a], c[b], c[d]]) * scale)
            normals.append(n)
            material.append(names.index(quad["material"]))
            geometry.append(objects.index(quad["object"]))
    mats = [config["materials"][m] for m in names]
    lights = []
    for li in config["lights"]:
        rows = [np.asarray(li["corner"]) * scale,
                np.asarray(li["edge01"]) * scale,
                np.asarray(li["edge02"]) * scale] + [
                    np.asarray(c, np.float64) for c in li["colours"]]
        lights.append(np.stack(rows))
    cam = config["camera"]
    pub = cam["published"]
    fov = 2.0 * math.degrees(math.atan(0.5 * pub["film_m"][1]
                                       / pub["focal_length_m"]))
    h, w = size or (config["height"], config["width"])
    return SceneData(
        tris=np.asarray(tris, np.float32),
        normals=np.asarray(normals, np.float32),
        material=np.asarray(material, np.int32),
        geometry=np.asarray(geometry, np.int32),
        kd=np.asarray([m["kd"] for m in mats], np.float32),
        ks=np.asarray([m["ks"] for m in mats], np.float32),
        shininess=np.asarray([m["shininess"] for m in mats], np.float32),
        lights=np.asarray(lights, np.float32),
        look_at=tuple(float(x) * scale for x in cam["look_at"]),
        rotation_deg=tuple(float(x) for x in cam["rotation_deg"]),
        distance=float(cam["distance"]) * scale,
        fov_y_deg=fov, height=int(h), width=int(w))
