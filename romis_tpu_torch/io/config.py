"""TOML configuration (reference ``romis_tpu/io/config.py``, the schema of
src/utils/config.{h,cpp}), the port's own copy:

- command_line_rendering: bool
- window_size: [w, h]                      (default [800, 800])
- data_path: str | "default"
- scene: int (SceneType ordinal) | name | obj filename
- output_dir: str (~ / $HOME expanded)
- [features]: snake_case Features fields (the reference's enable_* keys and
  the full set of this renderer's fields)
- [[cameras]]: field_of_view (deg), distance_from_look_at, look_at, rotation
- [[lights]]: { type = "point" | "segment" | "parallelogram", ... }
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field

from ..core.features import (
    Features, MISWeight, NeighbourSelectionStrategy, RayTraceMode,
)
from ..scene.lights import LightListBuilder

# Reference SceneType ordinals (src/scene/scene.h:18-26).
SCENE_NAMES = [
    "single_triangle",
    "cube",
    "cube_textured",
    "cornell_box",
    "cornell_box_parallelogram_light",
    "cornell_nightclub",
    "monkey",
]


@dataclass
class CameraConfig:
    """Reference CameraConfig defaults (src/utils/config.h:21-26)."""

    field_of_view: float = 30.0  # degrees
    distance_from_look_at: float = 25.0
    look_at: tuple = (2.57, 1.23, -1.35)
    rotation: tuple = (10.3, 30.0, 0.0)  # degrees


@dataclass
class Config:
    features: Features = field(default_factory=Features)
    cli_rendering_enabled: bool = False
    window_size: tuple = (1280, 720)
    data_path: str | None = None
    scene: str = "cornell_box_parallelogram_light"  # name or .obj path
    scene_is_file: bool = False
    output_dir: str = "."
    cameras: list = field(default_factory=list)
    lights: LightListBuilder = field(default_factory=LightListBuilder)


# The reference's feature booleans (config.cpp:229-247) mapped onto the
# Features field names; its dead flags are accepted and ignored (None).
_REF_FEATURE_MAP = {
    "enable_shading": "enable_shading",
    "enable_texture_mapping": "enable_texture_mapping",
    "enable_recursive": None,
    "enable_hard_shadow": None,
    "enable_soft_shadow": None,
    "enable_normal_interp": None,
    "enable_accel_structure": None,
}

_ENUM_FIELDS = {
    "ray_trace_mode": RayTraceMode,
    "mis_weight_rmis": MISWeight,
    "neighbour_selection_strategy": NeighbourSelectionStrategy,
}


def read_config_file(path: str) -> Config:
    """A TOML file of the reference's schema → Config."""
    with open(path, "rb") as f:
        table = tomllib.load(f)

    cfg = Config()
    cfg.cli_rendering_enabled = bool(table.get("command_line_rendering", True))
    ws = table.get("window_size", [800, 800])
    cfg.window_size = (int(ws[0]), int(ws[1]))

    data_path = table.get("data_path", "default")
    cfg.data_path = None if data_path == "default" else str(data_path)

    scene = table.get("scene", "cornell_box_parallelogram_light")
    if isinstance(scene, int):
        cfg.scene = SCENE_NAMES[scene]
    else:
        cfg.scene = str(scene)
        cfg.scene_is_file = cfg.scene not in SCENE_NAMES

    out = str(table.get("output_dir", "") or os.getcwd())
    if out.startswith("~"):
        out = os.path.expanduser(out)
    if out.startswith("$HOME"):
        out = out.replace("$HOME", os.environ.get("HOME", ""), 1)
    cfg.output_dir = os.path.abspath(out)

    fkw = {}
    for key, val in dict(table.get("features", {})).items():
        if key in _REF_FEATURE_MAP:
            if _REF_FEATURE_MAP[key]:
                fkw[_REF_FEATURE_MAP[key]] = bool(val)
        elif key in _ENUM_FIELDS:
            fkw[key] = _ENUM_FIELDS[key](val)
        elif key in Features.__dataclass_fields__:
            fkw[key] = val
    cfg.features = Features(**fkw)

    for cam in table.get("cameras", []):
        cfg.cameras.append(CameraConfig(
            field_of_view=float(cam.get("field_of_view", 50.0)),
            distance_from_look_at=float(cam.get("distance_from_look_at", 3.0)),
            look_at=tuple(cam.get("look_at", (0.0, 0.0, 0.0))),
            rotation=tuple(cam.get("rotation", (20.0, 20.0, 0.0))),
        ))
    if not cfg.cameras:
        cfg.cameras.append(CameraConfig())

    for light in table.get("lights", []):
        kind = light.get("type", "none")
        if kind == "point":
            cfg.lights.add_point(tuple(light.get("position", (0, 0, 0))),
                                 tuple(light.get("color", (0, 0, 0))))
        elif kind == "segment":
            eps = light.get("endpoints", [(0, 0, 0), (0, 0, 0)])
            cols = light.get("colors", [(0, 0, 0), (0, 0, 0)])
            cfg.lights.add_segment(tuple(eps[0]), tuple(eps[1]),
                                   tuple(cols[0]), tuple(cols[1]))
        elif kind == "parallelogram":
            edges = light.get("edges", [(0, 0, 0), (0, 0, 0)])
            cols = light.get("colors", [(0, 0, 0)] * 4)
            cfg.lights.add_parallelogram(
                tuple(light.get("corner", (0, 0, 0))),
                tuple(edges[0]), tuple(edges[1]),
                tuple(cols[0]), tuple(cols[1]), tuple(cols[2]),
                tuple(cols[3]))
    return cfg
