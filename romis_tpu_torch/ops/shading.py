"""Phong shading, target PDF, texture lookup and tone mapping (reference
``romis_tpu/ops/shading.py``), with the reference's epsilons and NaN scrubs:
the specular cosine is clamped at 0 before the pow, the inverse-square
falloff uses distance 1 within ``ZERO_EPSILON``, and lights behind the
surface or missed pixels shade to 0."""

from __future__ import annotations

import torch

from ..core.features import Features

from ..core.types import ShadeCtx
from ..core.vec import comp, e, vdot, vnorm, vnormalize

ZERO_EPSILON = 1e-5


def _scrub(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), 0.0, x)


def acquire_texel(tex_data, tex_size, tex_id, uv):
    """Nearest texel fetch (x = u*(W-1), y = v*(H-1)). tex_data [NT, TH, TW,
    3], tex_size [NT, 2], tex_id [..., H, W] (may be -1), uv [..., 2, H, W]
    → [..., 3, H, W] (garbage where tex_id < 0)."""
    tid = torch.clamp_min(tex_id, 0).long()
    th = tex_size[tid, 0].float()
    tw = tex_size[tid, 1].float()
    x = torch.clamp((comp(uv, 0) * (tw - 1.0)).int(), 0,
                    tex_data.shape[2] - 1).long()
    y = torch.clamp((comp(uv, 1) * (th - 1.0)).int(), 0,
                    tex_data.shape[1] - 1).long()
    return tex_data[tid, y, x].movedim(-1, -3)


def phong_shade(ctx: ShadeCtx, light_pos, light_color,
                features: Features) -> torch.Tensor:
    """Phong diffuse + specular with inverse-square falloff → [..., 3, H, W]
    (light_pos/light_color [..., 3, H, W], leading axes broadcast)."""
    if not features.enable_shading:
        return torch.broadcast_to(
            ctx.kd, torch.broadcast_shapes(ctx.kd.shape, light_pos.shape))
    p = ctx.position
    n = ctx.normal
    to_light = light_pos - p
    dist2 = vdot(to_light, to_light)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-24))
    l_dir = to_light / e(torch.clamp_min(dist, 1e-20))
    dot_nl = vdot(n, l_dir)

    v = vnormalize(ctx.view_origin - p)
    r = vnormalize(2.0 * e(dot_nl) * n - l_dir)
    cos_theta = vdot(r, v)

    diffuse = light_color * ctx.kd * e(dot_nl)
    cos_safe = torch.clamp_min(cos_theta, 1e-12)
    spec_pow = torch.where(cos_theta > 0.0,
                           torch.pow(cos_safe, ctx.shininess), 0.0)
    specular = light_color * ctx.ks * e(spec_pow)

    falloff_d = torch.where(dist < ZERO_EPSILON, 1.0, dist)
    out = (_scrub(diffuse) + _scrub(specular)) / e(falloff_d * falloff_d)
    out = torch.where(e(dot_nl < 0.0), 0.0, out)
    return torch.where(e(ctx.valid), out, 0.0)


def phong_shade_planes(ctx: ShadeCtx, px, py, pz, cr, cg, cb,
                       features: Features):
    """phong_shade on scalar component planes ([..., H, W] each) →
    (r, g, b) planes."""
    if not features.enable_shading:
        shp = torch.broadcast_shapes(ctx.kd[0].shape, px.shape)
        return tuple(torch.broadcast_to(ctx.kd[c], shp) for c in range(3))

    ppx, ppy, ppz = ctx.position[0], ctx.position[1], ctx.position[2]
    nx, ny, nz = ctx.normal[0], ctx.normal[1], ctx.normal[2]
    tox, toy, toz = px - ppx, py - ppy, pz - ppz
    dist2 = tox * tox + toy * toy + toz * toz
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-24))
    dinv = 1.0 / torch.clamp_min(dist, 1e-20)
    lx, ly, lz = tox * dinv, toy * dinv, toz * dinv
    dot_nl = nx * lx + ny * ly + nz * lz

    vx0 = ctx.view_origin[0] - ppx
    vy0 = ctx.view_origin[1] - ppy
    vz0 = ctx.view_origin[2] - ppz
    vsq = vx0 * vx0 + vy0 * vy0 + vz0 * vz0
    vok = vsq > 1e-30
    vn = torch.where(vok, torch.sqrt(torch.where(vok, vsq, 1.0)), 0.0)
    vinv = 1.0 / torch.clamp_min(vn, 1e-20)
    vx, vy, vz = vx0 * vinv, vy0 * vinv, vz0 * vinv

    rx0 = 2.0 * dot_nl * nx - lx
    ry0 = 2.0 * dot_nl * ny - ly
    rz0 = 2.0 * dot_nl * nz - lz
    rsq = rx0 * rx0 + ry0 * ry0 + rz0 * rz0
    rok = rsq > 1e-30
    rn = torch.where(rok, torch.sqrt(torch.where(rok, rsq, 1.0)), 0.0)
    rinv = 1.0 / torch.clamp_min(rn, 1e-20)
    cos_t = (rx0 * vx + ry0 * vy + rz0 * vz) * rinv

    cos_safe = torch.clamp_min(cos_t, 1e-12)
    spec_pow = torch.where(cos_t > 0.0, torch.pow(cos_safe, ctx.shininess),
                           0.0)
    falloff = torch.where(dist < ZERO_EPSILON, 1.0, dist)
    inv_f2 = 1.0 / (falloff * falloff)

    dead = (dot_nl < 0.0) | ~ctx.valid
    out = []
    for col, kd_c, ks_c in ((cr, ctx.kd[0], ctx.ks[0]),
                            (cg, ctx.kd[1], ctx.ks[1]),
                            (cb, ctx.kd[2], ctx.ks[2])):
        o = (_scrub(col * kd_c * dot_nl) + _scrub(col * ks_c * spec_pow)) \
            * inv_f2
        out.append(torch.where(dead, 0.0, o))
    return tuple(out)


def target_pdf_planes(ctx: ShadeCtx, px, py, pz, cr, cg, cb,
                      features: Features) -> torch.Tensor:
    """p-hat = ||phong||_2 on component planes → [..., H, W]."""
    r, g, b = phong_shade_planes(ctx, px, py, pz, cr, cg, cb, features)
    sq = r * r + g * g + b * b
    ok = sq > 1e-30
    return torch.where(ok, torch.sqrt(torch.where(ok, sq, 1.0)), 0.0)


def target_pdf(ctx: ShadeCtx, light_pos, light_color,
               features: Features) -> torch.Tensor:
    """p-hat on [..., 3, H, W] vectors → [..., H, W]."""
    return vnorm(phong_shade(ctx, light_pos, light_color, features))


def exposure_tone_mapping(color: torch.Tensor,
                          features: Features) -> torch.Tensor:
    """1 - exp(-exposure*c), then gamma."""
    mapped = 1.0 - torch.exp(-features.exposure * color)
    return torch.pow(torch.clamp_min(mapped, 0.0), 1.0 / features.gamma)
