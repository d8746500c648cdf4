"""RIS candidate generation (reference ``romis_tpu/ops/pallas_ris.py``).

Kernel 3 (``csrc/ris.cu``) replaces the Pallas ``_ris_kernel``: the whole
candidate loop per pixel in one thread, the light table in shared memory,
Philox4x32-10 random numbers in the kernel (or the ``uniforms`` test hook),
and an exponential race w / E per lane, which picks the same winner as the
plain version's Gumbel-max for the same uniforms. Its plain version is
``ops.wrs.gen_canonical_samples_plain``.

Kernel 14, the replay mode of the same source (``gen_canonical_replay``),
replaces the Pallas ``gen_canonical_replay_pallas``: the detached candidate
loop of the surrogate gradient, two independent races per lane, only their
replay records written (7K planes). Its plain version is
``ops.wrs.gen_canonical_replay_plain``.

Bound on the H100: compute, S Phong evaluations (one ``powf`` each) per
pixel with the whole reservoir state in registers; device memory sees 17
context planes in and 10K reservoir planes out.
"""

from __future__ import annotations

import torch

from romis_tpu.core.features import Features

from ..core.types import Reservoirs, ShadeCtx, unpack_reservoir_planes
from . import _build

CTX_PLANES = 17


def pack_ctx(ctx: ShadeCtx) -> torch.Tensor:
    """ShadeCtx → [17, H, W]: position3 | normal3 | view3 | kd3 | ks3 |
    shininess | valid."""
    return torch.cat([
        ctx.position, ctx.normal, ctx.view_origin, ctx.kd, ctx.ks,
        ctx.shininess[None], ctx.valid.float()[None],
    ], dim=0)


def _check_launch(ctx: ShadeCtx, lights, uniforms, n_uniforms: int,
                  features: Features):
    """Pack and check the kernel's inputs → (packed ctx, light rows)."""
    from .wrs import _lane_layout

    h, w = ctx.depth_t.shape[-2:]
    k = features.num_samples_in_reservoir
    sk, _, _ = _lane_layout(features.initial_light_samples, k)
    packed = pack_ctx(ctx)
    rows = lights.rows
    _build.check(packed, "ctx", torch.float32, (CTX_PLANES, h, w))
    _build.check(rows, "lights.rows", torch.float32)
    if rows.dim() != 2 or rows.shape[1] != 24:
        raise ValueError(f"lights.rows: expected [L, 24], got "
                         f"{tuple(rows.shape)}")
    if uniforms is not None:
        _build.check(uniforms, "uniforms", torch.float32,
                     (sk, n_uniforms, k, h, w))
    return packed, rows


def _seed(generator: torch.Generator) -> int:
    """A Philox key from the generator."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))


def gen_canonical_samples_ris(ctx: ShadeCtx, lights, num_lights: int,
                              features: Features, generator=None,
                              uniforms=None) -> Reservoirs:
    """S = initial_light_samples candidates over K = num_samples_in_reservoir
    lanes per pixel → Reservoirs [K, ..., H, W]. Random numbers: the
    ``uniforms`` [S/K, 4, K, H, W] when given, else drawn from
    ``generator`` (the plain version draws the uniforms themselves, the
    kernel a Philox key)."""
    from .wrs import gen_canonical_samples_plain

    h, w = ctx.depth_t.shape[-2:]
    s = features.initial_light_samples
    k = features.num_samples_in_reservoir
    if uniforms is None and generator is None:
        raise ValueError("RIS needs a torch.Generator or the uniforms")
    if not ctx.position.is_cuda:
        return gen_canonical_samples_plain(ctx, lights, num_lights, features,
                                           generator, uniforms)

    packed, rows = _check_launch(ctx, lights, uniforms, 4, features)
    if uniforms is not None:
        seed, u_ptr = 0, uniforms.data_ptr()
    else:
        seed, u_ptr = _seed(generator), None
    out = torch.empty((10 * k, h, w), dtype=torch.float32, device=packed.device)
    if h * w:
        _build.launch("romis_ris", packed.data_ptr(), h * w, rows.data_ptr(),
                      rows.shape[0], num_lights, s, k, seed, u_ptr,
                      out.data_ptr())
        gen_canonical_samples_ris.launches += 1
    return unpack_reservoir_planes(out, k)


gen_canonical_samples_ris.launches = 0


@torch.no_grad()
def gen_canonical_replay(ctx: ShadeCtx, lights, num_lights: int,
                         features: Features, generator=None, uniforms=None):
    """The detached replay RIS → (w_sum [K, H, W], replay1, replay2), each
    replay a (light index as f32, u, v) tuple of [K, H, W] planes. Random
    numbers: ``uniforms`` [S/K, 5, K, H, W] when given, else drawn from
    ``generator`` (the plain version draws the uniforms themselves, the
    kernel a Philox key). Kernel 14 for CUDA tensors, the plain version for
    CPU tensors."""
    from .wrs import gen_canonical_replay_plain

    h, w = ctx.depth_t.shape[-2:]
    s = features.initial_light_samples
    k = features.num_samples_in_reservoir
    if uniforms is None and generator is None:
        raise ValueError("the replay RIS needs a torch.Generator or the "
                         "uniforms")
    if not ctx.position.is_cuda:
        return gen_canonical_replay_plain(ctx, lights, num_lights, features,
                                          generator, uniforms)
    packed, rows = _check_launch(ctx, lights, uniforms, 5, features)
    if uniforms is not None:
        seed, u_ptr = 0, uniforms.data_ptr()
    else:
        seed, u_ptr = _seed(generator), None
    out = torch.empty((k, 7, h, w), dtype=torch.float32, device=packed.device)
    if h * w:
        _build.launch("romis_ris_replay", packed.data_ptr(), h * w,
                      rows.data_ptr(), rows.shape[0], num_lights, s, k, seed,
                      u_ptr, out.data_ptr())
        gen_canonical_replay.launches += 1
    return out[:, 0], (out[:, 1], out[:, 2], out[:, 3]), \
        (out[:, 4], out[:, 5], out[:, 6])


gen_canonical_replay.launches = 0
