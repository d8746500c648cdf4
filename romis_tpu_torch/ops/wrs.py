"""Weighted reservoir sampling as order-invariant, vectorised math
(reference ``romis_tpu/ops/wrs.py``).

- K fixed lanes: candidate j goes to lane j mod K (candidate generation)
  and an input reservoir's lane-k sample feeds output lane k (combination).
- A race replaces streaming accept/reject: within a lane the winner is
  argmax(log w + Gumbel noise), which selects index i with probability
  w_i / sum(w) and is order-invariant.

Random numbers come from an explicit ``torch.Generator`` on the tensors'
device, or are injected (the ``uniforms`` / ``gumbel`` test hooks), so the
same inputs give the same reservoirs as the JAX package.

Layout: reservoir fields are [K, ..., H, W]; stacked inputs [R, K, ..., H, W]
with the combine reducing over the leading R axis.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from romis_tpu.core.features import Features

from ..core.types import Reservoirs, ShadeCtx
from ..core.vec import e, vnorm
from .intersect import intersect_any
from .shading import target_pdf, target_pdf_planes

SHADOW_RAY_EPSILON = 1e-3


def visibility(ctx_position, sample_pos, geometry,
               any_hit=intersect_any) -> torch.Tensor:
    """Shadow-ray visibility from surface points [3, H, W] to light samples
    [..., 3, H, W] → bool [..., H, W] (True = visible). The direction comes
    from the unoffset point, the origin is pushed SHADOW_RAY_EPSILON along
    it, t_max is the remaining distance; coincident pairs are visible.
    ``any_hit`` traces the occlusion rays (the plain block scan by default,
    ``ops.trace.any_hit`` for the kernel)."""
    to = sample_pos - ctx_position
    dist = vnorm(to)
    d = to / e(torch.clamp_min(dist, 1e-20))
    origin = ctx_position + SHADOW_RAY_EPSILON * d
    t_max = vnorm(sample_pos - origin)
    occluded = any_hit(origin, d, t_max, geometry)
    return (~occluded) | (dist <= SHADOW_RAY_EPSILON)


def visibility_from(from_position, sample_pos, geometry,
                    any_hit=intersect_any) -> torch.Tensor:
    """visibility() from per-sample origins (the inputs' own surface points
    in the unbiased Z-count). from_position [..., 3, H, W] broadcasts
    against sample_pos."""
    to = sample_pos - from_position
    dist = vnorm(to)
    d = to / e(torch.clamp_min(dist, 1e-20))
    origin = (from_position + SHADOW_RAY_EPSILON * d).expand(d.shape)
    t_max = vnorm(sample_pos - origin)
    occluded = any_hit(origin, d, t_max, geometry)
    return (~occluded) | (dist <= SHADOW_RAY_EPSILON)


def _lane_layout(s: int, k: int):
    """S candidates → K lanes of ceil(S/K) slots, candidate j in lane
    j mod K, slot j // K. → (slots_per_lane, per-lane counts [K] f32,
    real mask [slots, K])."""
    sk = -(-s // k)
    j = np.arange(sk * k).reshape(sk, k)
    real = j < s
    counts = real.sum(axis=0).astype(np.float32)
    return sk, counts, real


def _safe_big_w(w_sum, p_hat, m, cond):
    """W = wSum / (p_hat * m) under ``cond`` else 0."""
    denom = torch.where(cond, p_hat * m, 1.0)
    return torch.where(cond, w_sum / denom, 0.0)


def ris_uniforms(generator: torch.Generator, s: int, k: int, height: int,
                 width: int) -> torch.Tensor:
    """The RIS random numbers [S/K, 4, K, H, W] (light pick, u, v, race per
    slot and lane), drawn on the generator's device."""
    sk = -(-s // k)
    return torch.rand((sk, 4, k, height, width), generator=generator,
                      device=generator.device)


def gen_canonical_samples_plain(ctx: ShadeCtx, lights, num_lights: int,
                                features: Features, generator=None,
                                uniforms=None) -> Reservoirs:
    """The plain version of the RIS kernel: S candidates per pixel streamed
    slot by slot (one candidate per lane per slot, all K lanes at once),
    uniform light pick, uniform point on the light, weight p_hat·L, running
    Gumbel-max per lane; W = wSum / (p_hat·M).

    ``uniforms`` [S/K, 4, K, H, W] holds, per slot, what the JAX path draws
    as ``u4`` (light pick, u, v, race); without it they are drawn from
    ``generator``."""
    from ..scene.lights import sample_lights_planes
    from .rows import gather_rows_plain

    h, w_img = ctx.depth_t.shape[-2:]
    s = features.initial_light_samples
    k = features.num_samples_in_reservoir
    sk, lane_counts, lane_real = _lane_layout(s, k)
    dev = ctx.position.device
    if uniforms is None:
        uniforms = ris_uniforms(generator, s, k, h, w_img)
    if tuple(uniforms.shape) != (sk, 4, k, h, w_img):
        raise ValueError(f"uniforms: expected {(sk, 4, k, h, w_img)}, got "
                         f"{tuple(uniforms.shape)}")

    def zeros():
        return torch.zeros((k, h, w_img), device=dev)

    w_sum = zeros()
    best = torch.full((k, h, w_img), -torch.inf, device=dev)
    sel = [zeros() for _ in range(6)]
    sel_w, sel_p_hat = zeros(), zeros()
    real_all = torch.as_tensor(lane_real, dtype=torch.float32, device=dev)
    for slot in range(sk):
        u4 = uniforms[slot]
        idx = torch.clamp_max((u4[0] * num_lights).int(), num_lights - 1)
        g = -torch.log(-torch.log(torch.clamp_min(u4[3], 1e-37)) + 1e-37)
        comps = sample_lights_planes(lights, idx, u4[1], u4[2],
                                     gather=gather_rows_plain)
        p_hat = target_pdf_planes(ctx, *comps, features)
        w = p_hat * float(num_lights) * real_all[slot][:, None, None]
        score = torch.where(w > 0.0,
                            torch.log(torch.clamp_min(w, 1e-37)) + g,
                            -torch.inf)
        upd = score > best
        w_sum = w_sum + w
        best = torch.where(upd, score, best)
        sel = [torch.where(upd, c, sc) for c, sc in zip(comps, sel)]
        sel_w = torch.where(upd, w, sel_w)
        sel_p_hat = torch.where(upd, p_hat, sel_p_hat)

    m = torch.as_tensor(lane_counts, device=dev)[:, None, None].expand(
        k, h, w_img).contiguous()
    big_w = _safe_big_w(w_sum, sel_p_hat, m, sel_p_hat > 0.0)
    return Reservoirs(pos=torch.stack(sel[0:3], dim=1),
                      color=torch.stack(sel[3:6], dim=1), w_sum=w_sum, m=m,
                      big_w=big_w, chosen_w=sel_w)


def gen_canonical_samples(ctx: ShadeCtx, lights, num_lights: int, geometry,
                          features: Features, generator=None, uniforms=None,
                          ris=None, any_hit=None) -> Reservoirs:
    """Per-pixel RIS candidate generation (reference genCanonicalSamples):
    ``ris`` (kernel 3 by default: the plain version for CPU tensors), then
    the optional initial visibility check, which zeroes W where the winner
    is occluded, through ``any_hit`` (kernel 6 by default). Give a
    ``generator`` on the tensors' device, or the ``uniforms`` test hook."""
    from .ris import gen_canonical_samples_ris
    from .trace import any_hit as any_hit_kernel

    ris = ris or gen_canonical_samples_ris
    res = ris(ctx, lights, num_lights, features, generator=generator,
              uniforms=uniforms)
    if features.initial_samples_visibility_check:
        vis = visibility(ctx.position, res.pos, geometry,
                         any_hit or any_hit_kernel)
        res = replace(res, big_w=torch.where(vis, res.big_w, 0.0))
    return res


def _stream_weights(receiver: ShadeCtx, inputs: Reservoirs, in_mask,
                    features):
    """Per-input resampling weight at the receiver, w = p_hat(y)·W·M.
    inputs fields [R, K, ..., H, W]; in_mask [R, H, W] → w, p_hat
    [R, K, H, W]."""
    p, c = inputs.pos, inputs.color
    p_hat = target_pdf_planes(
        receiver, p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :],
        c[..., 0, :, :], c[..., 1, :, :], c[..., 2, :, :], features)
    w = p_hat * inputs.big_w * inputs.m
    w = torch.where(in_mask[:, None], w, 0.0)
    return w, p_hat


def _select_lanewise(gumbel, w, p_hat, inputs: Reservoirs, in_mask):
    """Gumbel-max winner over the leading R axis, per output lane.
    w/p_hat/gumbel: [R, K, H, W]."""
    score = torch.where(w > 0.0,
                        torch.log(torch.clamp_min(w, 1e-37)) + gumbel,
                        -torch.inf)
    win = torch.argmax(score, dim=0)  # [K, H, W], first maximum wins ties
    r = w.shape[0]

    def gather(a):
        win_b = win if a.dim() == 4 else win[:, None]
        out = torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device)
        for i in range(r):
            out = torch.where(win_b == i, a[i], out)
        return out

    w_sum = w.sum(dim=0)
    m_out = torch.where(in_mask[:, None], inputs.m, 0.0).sum(dim=0)
    return (gather(inputs.pos), gather(inputs.color), gather(w),
            gather(p_hat), w_sum, m_out)


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-37)))


def combine_biased(receiver: ShadeCtx, inputs: Reservoirs, in_mask,
                   features: Features, gumbel: torch.Tensor) -> Reservoirs:
    """ReSTIR Algorithm 5: re-weight every input sample by
    p_hat_receiver·W·M, resample one winner per lane with the race noise
    ``gumbel`` [R, K, H, W], then W = wSum / (p_hat(winner)·M_total)."""
    w, p_hat = _stream_weights(receiver, inputs, in_mask, features)
    sel_pos, sel_color, sel_w, sel_p_hat, w_sum, m_out = _select_lanewise(
        gumbel, w, p_hat, inputs, in_mask)
    big_w = _safe_big_w(w_sum, sel_p_hat, m_out,
                        (sel_p_hat > 0.0) & (m_out > 0.0))
    return Reservoirs(pos=sel_pos, color=sel_color, w_sum=w_sum, m=m_out,
                      big_w=big_w, chosen_w=sel_w)


def combine_unbiased(receiver: ShadeCtx, inputs: Reservoirs, in_mask,
                     input_ctxs: ShadeCtx, features: Features,
                     gumbel: torch.Tensor, geometry=None,
                     any_hit=intersect_any) -> Reservoirs:
    """ReSTIR Algorithm 6: the biased combine's race, but W = wSum /
    (p_hat(winner)·Z), where Z sums the lane M of every input whose own
    target PDF of the winner (times its visibility with
    ``spatial_reuse_visibility_check``) is positive. ``input_ctxs`` holds
    each input's geometry, fields [R, ..., H, W]."""
    w, p_hat = _stream_weights(receiver, inputs, in_mask, features)
    sel_pos, sel_color, sel_w, sel_p_hat, w_sum, m_out = _select_lanewise(
        gumbel, w, p_hat, inputs, in_mask)
    # The K winners at every input's geometry: [R, 1, ...] x [K, ...].
    ctx_r = ShadeCtx(**{f: getattr(input_ctxs, f)[:, None] for f in (
        "valid", "position", "normal", "view_origin", "kd", "ks",
        "shininess", "geom_id", "depth_t")})
    p_hat_at_inputs = target_pdf(ctx_r, sel_pos, sel_color, features)
    if features.spatial_reuse_visibility_check:
        vis = visibility_from(input_ctxs.position[:, None], sel_pos, geometry,
                              any_hit)
        p_hat_at_inputs = torch.where(vis, p_hat_at_inputs, 0.0)
    z = torch.where((p_hat_at_inputs > 0.0) & in_mask[:, None], inputs.m,
                    0.0).sum(dim=0)
    big_w = _safe_big_w(w_sum, sel_p_hat, z, (sel_p_hat > 0.0) & (z > 0.0))
    return Reservoirs(pos=sel_pos, color=sel_color, w_sum=w_sum, m=m_out,
                      big_w=big_w, chosen_w=sel_w)


def clamp_temporal_m(prev: Reservoirs, current_total_m,
                     clamp: float) -> Reservoirs:
    """Temporal M-clamping: where the predecessor's total M exceeds
    clamp·current_total_m + 1, rescale each lane's wSum by (bound / M_lane)
    and set M_lane = bound."""
    bound = clamp * current_total_m + 1.0  # [H, W]
    needs = prev.total_m() > bound
    lane_nonzero = prev.m > 0.0
    scale = torch.where(lane_nonzero,
                        bound[None] / torch.clamp_min(prev.m, 1e-37), 1.0)
    apply = needs[None] & lane_nonzero
    return Reservoirs(
        pos=prev.pos, color=prev.color,
        w_sum=torch.where(apply, prev.w_sum * scale, prev.w_sum),
        m=torch.where(apply, bound[None].expand(prev.m.shape), prev.m),
        big_w=prev.big_w, chosen_w=prev.chosen_w)
