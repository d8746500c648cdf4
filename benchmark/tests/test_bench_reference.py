"""The plain references against the program's plain versions on the CPU
(where every draw comes from the generator), their Philox against the
published known answers, and the configuration's camera against the
published one."""

import json
import math

import numpy as np
import pytest
import torch

from harness.manifest import BENCH_DIR, Manifest
from harness.scenedata import load
from reference import philox, restir

CELL = "cornell_box.restir"


def _cell():
    return Manifest.load().cell(CELL)


CELLS = [w["name"] for w in Manifest.load().data["workloads"]]


@pytest.mark.parametrize("seed", [1, 2147483651, 3000000019])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_the_programs_plain_frames(cell, seed):
    man = Manifest.load()
    c = man.cell(cell)
    n = int(c.traffic["check_units"])
    d = man.drive(c.traffic["drive"]).Drive(c.config, c.traffic, seed,
                                            torch.device("cpu"), (20, 24))
    for _ in range(n):
        d.check_unit()
    ref = man.reference(c.traffic["reference"])
    want = ref.expected(c.config, c.traffic, seed, "cpu", n, (20, 24))
    nums = ref.numbers(d.result(), want)
    assert nums["mismatch"] <= 1e-3 and nums["mean_gap"] <= 1e-6, nums
    assert float(want[-1].mean()) > 0.05


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, 0xFFFFFFFFFFFFFFFF,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0x299F31D0 << 32) | 0xA4093822,
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for philox4x32_10."""
    words = philox.philox4x32_10(
        *(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in words) == want


def test_selection_scores_follow_the_word_order():
    """Box cell o takes word o mod 4 of counter o div 4."""
    key = 55555555555
    sc = philox.selection_scores(key, 10, 7, "cpu", chunk=2)
    ctr = torch.tensor([2], dtype=torch.int64)
    pix = torch.tensor([3], dtype=torch.int64)
    words = philox.philox4x32_10(ctr, pix, torch.zeros_like(pix),
                                 torch.tensor([philox.TAG_SELECT]), key)
    assert float(sc[9, 3]) == float(philox.gumbel(words[1])[0])


def test_draw_words_keep_their_ranges():
    dy, dx, g = philox.spatial_pass(123456789012, 1, 5, 2, 10, 500, "cpu")
    assert dy.shape == dx.shape == (5, 500) and g.shape == (6, 2, 500)
    assert int(dy.min()) >= -10 and int(dy.max()) <= 10
    assert int(dx.min()) == -10 and int(dx.max()) == 10
    u = philox.ris_slot(987654321, 3, 2, 1000, "cpu")
    assert all(float(a.min()) >= 0.0 and float(a.max()) < 1.0 for a in u)


def test_camera_is_the_published_one():
    conf = json.loads((BENCH_DIR / "configs/cornell_box_1080.json")
                      .read_text())
    d = load(conf)
    pub = conf["camera"]["published"]
    origin, dirs = restir.primary_rays(d, "cpu")
    np.testing.assert_allclose(origin.numpy(), np.asarray(pub["position"])
                               * conf["scale"], atol=1e-6)
    centre = dirs.reshape(3, d.height, d.width)[:, d.height // 2,
                                                d.width // 2]
    np.testing.assert_allclose(centre.numpy(), pub["direction"], atol=2e-3)
    assert d.fov_y_deg == pytest.approx(
        2 * math.degrees(math.atan(0.0125 / 0.035)))


def test_every_triangle_faces_its_side():
    conf = json.loads((BENCH_DIR / "configs/cornell_box_1080.json")
                      .read_text())
    d = load(conf)
    assert d.tris.shape == (36, 3, 3)
    centre = np.asarray(conf["room_centre"]) * conf["scale"]
    for i, q in enumerate(conf["quads"]):
        for t in (2 * i, 2 * i + 1):
            to_centre = centre - d.tris[t, 0]
            facing = float(np.dot(to_centre, d.normals[t]))
            assert facing > 0 if q["faces"] == "room" else True


def test_an_unmodelled_setting_is_refused():
    c = _cell()
    with pytest.raises(ValueError):
        restir.settings(c.config, {"features": {
            "unbiased_combination": True}})
