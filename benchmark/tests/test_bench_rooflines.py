"""The frozen roofline arithmetic reproduces the bounds the port's kernel
table was held to (at 1920x1080 on the flagship scene): kernel 3 on its
Philox stream 0.8656 ms, kernel 17 in R-OMIS direct 1.0181 ms and in its
ext_vis mode 0.9344 ms. The flagship's hit pixels are counted by the
program's own plain closest hit: a test may import the program."""

import pytest
import torch

from rooflines import counts

HW = 1920 * 1080


def test_kernel3_philox():
    ms = 1e3 * counts.bound_s(*counts.ris_philox(HW, 32, 2))
    assert round(ms, 4) == 0.8656


def test_kernel17_ext_vis():
    ms = 1e3 * counts.bound_s(*counts.sweep_romis(HW, 5, 2, ext_vis=True))
    assert round(ms, 4) == 0.9344


def test_kernel17_romis_direct_on_the_flagship():
    from romis_tpu_torch.core.camera import generate_rays
    from romis_tpu_torch.ops.trace import closest_hit_plain
    from romis_tpu_torch.scene.scene import flagship_camera, flagship_scene

    scene = flagship_scene("cpu")
    cam = flagship_camera(1080, 1920, "cpu")
    with torch.no_grad():
        _, tri, _, _ = closest_hit_plain(generate_rays(cam, 1080, 1920),
                                         scene.geometry)
    hits = int((tri >= 0).sum())
    slots = scene.geometry.tri_cols.shape[1]
    ms = 1e3 * counts.bound_s(*counts.sweep_romis(HW, 5, 2, slots, hits))
    assert round(ms, 4) == 1.0181


@pytest.mark.parametrize("n_bytes, n_ops", [(3.35e9, 0), (0, 6.7e10),
                                             (3.35e9, 6.7e10)])
def test_bound_is_the_larger_limit(n_bytes, n_ops):
    assert counts.bound_s(n_bytes, n_ops) == pytest.approx(1e-3)
