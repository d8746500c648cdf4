"""The port's neighbour gather (kernel 12's entry, ``ops.spatial.
neighbour_gather``) against the JAX package's ``spatial_neighbour_gather_
pallas``, and its own draws: with the offsets the Pallas kernel drew (in
interpret mode, recovered from a coordinate plane, as
``test_pallas.py:82-108`` reads them) every plane is bit-equal; with
injected offsets it is the clamped halo gather; without them its Philox
offsets (``neighbour_offsets``, the kernel's stream, the standard
Philox4x32-10) stay in the clamped ±r window, are shared by the planes,
are drawn per pixel, and cover the 2r + 1 values."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from romis_tpu.ops.pallas_spatial import spatial_neighbour_gather_pallas
from romis_tpu_torch.ops import spatial
from romis_tpu_torch.utils import stats

COORD = 4096  # plane 0 holds y·4096 + x, exact in float32 at these sizes


def _coord_planes(h, w, rng):
    coord = (np.arange(h)[:, None] * COORD
             + np.arange(w)[None, :]).astype(np.float32)
    return np.stack([coord, 2.0 * coord,
                     rng.normal(size=(h, w)).astype(np.float32)])


def _recovered_offsets(g, h, w):
    """Gathered planes [R, C, H, W] → the offsets [2, R, H, W] their
    coordinate plane records."""
    v = np.asarray(g)[:, 0].astype(np.int64)
    return np.stack([v // COORD - np.arange(h)[None, :, None],
                     v % COORD - np.arange(w)[None, None, :]]).astype(
                         np.int32)


def test_matches_pallas_kernel_at_its_offsets():
    h, w, r, n_nbr = 64, 200, 10, 3
    planes = _coord_planes(h, w, np.random.default_rng(0))
    expect = np.asarray(spatial_neighbour_gather_pallas(
        7, jnp.asarray(planes), n_nbr, r,
        interpret=pltpu.InterpretParams()))
    offs = _recovered_offsets(expect, h, w)
    # The reference drew offsets, its dx shared down each column.
    assert (offs != 0).any()
    assert (offs[1] == offs[1][:, :1, :]).all()
    got = spatial.neighbour_gather(torch.from_numpy(planes), n_nbr, r,
                                   offsets=torch.from_numpy(offs))
    assert got.shape == (n_nbr, 3, h, w)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_injected_offsets_are_the_clamped_halo_gather():
    h, w, r, n_nbr, c = 12, 20, 6, 5, 7
    gen = torch.Generator().manual_seed(1)
    planes = torch.randn((c, h, w), generator=gen)
    offs, _ = spatial.spatial_noise(gen, n_nbr, 1, r, h, w)
    stats.launches.clear()
    got = spatial.neighbour_gather(planes, n_nbr, r, offsets=offs)
    assert stats.launches == {}
    dy, dx = spatial.clamped_offsets(offs, h, w)
    assert torch.equal(got, spatial.halo_offset_gather_plain(planes, dy, dx))
    assert torch.equal(got, spatial.neighbour_gather_plain(planes, offs))
    with pytest.raises(ValueError, match="key or offsets"):
        spatial.neighbour_gather(planes, n_nbr, r)


def test_philox_draws_stay_in_the_clamped_window():
    h, w, r, n_nbr = 48, 64, 10, 5
    planes = torch.from_numpy(_coord_planes(h, w, np.random.default_rng(2)))
    key = spatial.philox_key(torch.Generator().manual_seed(3))
    got = spatial.neighbour_gather(planes, n_nbr, r, key=key, pass_index=1)
    offs = _recovered_offsets(got.numpy(), h, w)
    ys = np.arange(h)[None, :, None]
    xs = np.arange(w)[None, None, :]
    sy, sx = offs[0] + ys, offs[1] + xs
    assert ((sy >= np.maximum(ys - r, 0)) & (sy <= np.minimum(ys + r, h - 1))
            ).all()
    assert ((sx >= np.maximum(xs - r, 0)) & (sx <= np.minimum(xs + r, w - 1))
            ).all()
    # Every plane carries the same offset.
    np.testing.assert_array_equal(got[:, 1].numpy(), 2.0 * got[:, 0].numpy())
    # The draws are kernel 12's stream: unclamped in the interior.
    drawn = spatial.neighbour_offsets(key, 1, n_nbr, r, h, w)
    inner = (slice(None), slice(None), slice(r, h - r), slice(r, w - r))
    np.testing.assert_array_equal(offs[inner], drawn.numpy()[inner])
    assert torch.equal(got, spatial.neighbour_gather_plain(planes, drawn))
    # Per pixel, not per column; every value of [-r, r] drawn about equally.
    assert (drawn[1] != drawn[1][:, :1]).any()
    for axis in range(2):
        counts = np.bincount(drawn[axis].numpy().ravel() + r,
                             minlength=2 * r + 1)
        assert counts.size == 2 * r + 1
        share = counts / counts.sum()
        assert np.abs(share - 1.0 / (2 * r + 1)).max() < 0.01
    # Another pass index, another draw.
    other = spatial.neighbour_offsets(key, 2, n_nbr, r, h, w)
    assert (other != drawn).float().mean() > 0.9


def test_philox_matches_known_answers():
    """The PyTorch Philox4x32-10 against the generator's published
    known-answer vectors, so it is the generator the kernels implement."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, expect in cases:
        out = spatial.philox4x32_10(
            [torch.tensor([c], dtype=torch.int64) for c in ctr],
            *(torch.tensor([k], dtype=torch.int64) for k in key))
        assert tuple(int(x) for x in out) == expect
