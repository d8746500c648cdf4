"""Feature flags and parameters of the renderer (reference
``romis_tpu/core/features.py``, kept field for field: the same names,
defaults, enums and JSON form, so a configuration written by one package
loads in the other through ``to_json`` / ``from_dict``).

The reference ``Features`` struct is src/utils/common.h:89-148. This is a
frozen, hashable dataclass; ``ray_trace_mode`` defaults to ReSTIR (the C++
reference defaults to R-OMIS).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass


class RayTraceMode(enum.Enum):
    """Reference: src/utils/common.h:25-29."""

    RESTIR = "restir"
    RMIS = "rmis"
    ROMIS = "romis"


class MISWeight(enum.Enum):
    """Reference: src/utils/common.h:31-34."""

    EQUAL = "equal"
    BALANCE = "balance"


class NeighbourSelectionStrategy(enum.Enum):
    """Reference: src/utils/common.h:36-41."""

    RANDOM = "random"
    SIMILAR = "similar"
    DISSIMILAR = "dissimilar"
    EQUAL_SIMILAR_DISSIMILAR = "equal_similar_dissimilar"


@dataclass(frozen=True)
class Features:
    """Renderer feature flags and parameters."""

    enable_shading: bool = True
    enable_texture_mapping: bool = True

    # Shared RIS / ReSTIR parameters.
    ray_trace_mode: RayTraceMode = RayTraceMode.RESTIR
    initial_samples_visibility_check: bool = False
    num_samples_in_reservoir: int = 2  # K lanes
    initial_light_samples: int = 32  # RIS candidates per pixel
    num_neighbours_to_sample: int = 5
    spatial_resample_radius: int = 10

    # Neighbour-selection similarity gates (the normal gate compares against
    # the cosine of the angle).
    neighbour_same_geometry: bool = True
    neighbour_max_depth_difference_fraction: float = 0.10
    neighbour_max_normal_angle_difference_radians: float = 0.436332

    # R-MIS / R-OMIS parameters.
    max_iterations_mis: int = 5
    neighbour_selection_strategy: NeighbourSelectionStrategy = (
        NeighbourSelectionStrategy.SIMILAR
    )
    mis_weight_rmis: MISWeight = MISWeight.EQUAL
    use_progressive_romis: bool = False
    progressive_update_mod: int = 1

    # ReSTIR flags.
    unbiased_combination: bool = False
    spatial_reuse: bool = True
    spatial_reuse_visibility_check: bool = False
    temporal_reuse: bool = True
    spatial_resampling_passes: int = 2
    temporal_clamp_m: int = 20

    # Fused neighbour kernels (neighbour selection, the MIS sweep) where the
    # tensors are on the card.
    fused_spatial_gather: bool = True

    # Fused resampling kernels (RIS, the spatial passes, the MIS sweep),
    # which have no backward: gradient paths set this False.
    fused_resampling: bool = True

    # Gradient-path RIS: the winner-replay surrogate backward.
    surrogate_resampling_grad: bool = False

    # Closed-form Phong VJPs in the reference; the port differentiates the
    # same formula with autograd and ignores the flag.
    analytic_phong_vjp: bool = False

    # Gradient paths: one spatial offset per (pass, neighbour) instead of
    # per pixel, unless exact_gradients is set.
    coherent_spatial_offsets: bool = False
    exact_gradients: bool = False

    # Temporal reprojection with camera motion vectors, within
    # ±reprojection_radius pixels.
    temporal_reprojection: bool = False
    reprojection_radius: int = 16

    # Tone mapping.
    enable_tone_mapping: bool = True
    gamma: float = 1.0
    exposure: float = 1.5

    def replace(self, **kw) -> "Features":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        """Every field as JSON, enums by value."""
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, enum.Enum):
                d[k] = v.value
        return json.dumps(d, indent=2)

    @staticmethod
    def from_dict(d: dict) -> "Features":
        kw = dict(d)
        if "ray_trace_mode" in kw:
            kw["ray_trace_mode"] = RayTraceMode(kw["ray_trace_mode"])
        if "mis_weight_rmis" in kw:
            kw["mis_weight_rmis"] = MISWeight(kw["mis_weight_rmis"])
        if "neighbour_selection_strategy" in kw:
            kw["neighbour_selection_strategy"] = NeighbourSelectionStrategy(
                kw["neighbour_selection_strategy"]
            )
        return Features(**kw)
