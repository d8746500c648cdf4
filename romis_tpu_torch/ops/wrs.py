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

The winner-replay surrogate gradient (``Features.surrogate_resampling_grad``)
runs each race detached and re-evaluates only its winners differentiably:
``gen_canonical_surrogate`` (RIS, whose detached candidate loop is the
replay kernel 14, ``ops.ris.gen_canonical_replay``) and
``combine_biased_surrogate`` (the reuse combines). Replay records
[K, 3, H, W] (light index | u | v, index -1 for none) carry each winner
through the reuse phases so that its position and colour are re-derived
from the light table.

Layout: reservoir fields are [K, ..., H, W]; stacked inputs [R, K, ..., H, W]
with the combine reducing over the leading R axis.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..core.features import Features

from ..core.types import Reservoirs, ShadeCtx, detached
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
    ``ops.trace.any_hit`` for the kernel). The boolean has no gradient, so
    the inputs are detached."""
    ctx_position, sample_pos = ctx_position.detach(), sample_pos.detach()
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
    from_position, sample_pos = from_position.detach(), sample_pos.detach()
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


def _gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-37)) + 1e-37)


def gen_canonical_samples_plain(ctx: ShadeCtx, lights, num_lights: int,
                                features: Features, generator=None,
                                uniforms=None, row_base: int = 0,
                                h_global=None) -> Reservoirs:
    """The plain version of the RIS kernel: S candidates per pixel streamed
    slot by slot (one candidate per lane per slot, all K lanes at once),
    uniform light pick, uniform point on the light, weight p_hat·L, running
    Gumbel-max per lane; W = wSum / (p_hat·M).

    ``uniforms`` [S/K, 4, K, H, W] holds, per slot, what the JAX path draws
    as ``u4`` (light pick, u, v, race); without it they are drawn from
    ``generator``: for a row band (``h_global``, ``ops.band``) the whole
    frame's, of which the band takes its rows."""
    from ..scene.lights import sample_lights_planes
    from .band import band_of, check_band
    from .rows import gather_rows_plain

    h, w_img = ctx.depth_t.shape[-2:]
    s = features.initial_light_samples
    k = features.num_samples_in_reservoir
    sk, lane_counts, lane_real = _lane_layout(s, k)
    dev = ctx.position.device
    h_frame = check_band("RIS", h, row_base, h_global)
    if uniforms is None:
        uniforms = band_of(ris_uniforms(generator, s, k, h_frame, w_img),
                           row_base, h)
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
        g = _gumbel_from_uniform(u4[3])
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


def replay_uniforms(generator: torch.Generator, s: int, k: int, height: int,
                    width: int) -> torch.Tensor:
    """The replay RIS random numbers [S/K, 5, K, H, W] (light pick, u, v,
    race 1, race 2 per slot and lane), drawn on the generator's device."""
    sk = -(-s // k)
    return torch.rand((sk, 5, k, height, width), generator=generator,
                      device=generator.device)


@torch.no_grad()
def gen_canonical_replay_plain(ctx: ShadeCtx, lights, num_lights: int,
                               features: Features, generator=None,
                               uniforms=None, row_base: int = 0,
                               h_global=None):
    """The plain version of the replay kernel: the reference's detached
    surrogate scan (``ops/wrs._gen_canonical_surrogate``). S candidates per
    pixel as in ``gen_canonical_samples_plain``, two independent Gumbel-max
    races over them → (w_sum [K, H, W], replay1, replay2), each replay a
    (light index as f32, u, v) tuple of [K, H, W] planes (zeros in a lane
    without a positive weight).

    ``uniforms`` [S/K, 5, K, H, W] holds, per slot, the reference's ``u4``
    (pick, u, v, race 1) and the second race's uniform; without it they are
    drawn from ``generator``: for a row band (``h_global``, ``ops.band``)
    the whole frame's, of which the band takes its rows."""
    from ..scene.lights import sample_lights_planes
    from .band import band_of, check_band
    from .rows import gather_rows_plain

    h, w_img = ctx.depth_t.shape[-2:]
    s = features.initial_light_samples
    k = features.num_samples_in_reservoir
    sk, _, lane_real = _lane_layout(s, k)
    dev = ctx.position.device
    h_frame = check_band("replay RIS", h, row_base, h_global)
    if uniforms is None:
        uniforms = band_of(replay_uniforms(generator, s, k, h_frame, w_img),
                           row_base, h)
    if tuple(uniforms.shape) != (sk, 5, k, h, w_img):
        raise ValueError(f"uniforms: expected {(sk, 5, k, h, w_img)}, got "
                         f"{tuple(uniforms.shape)}")
    zeros = torch.zeros((k, h, w_img), device=dev)
    w_sum = zeros
    best = [torch.full((k, h, w_img), -torch.inf, device=dev)
            for _ in range(2)]
    rec = [[zeros] * 3 for _ in range(2)]
    real_all = torch.as_tensor(lane_real, dtype=torch.float32, device=dev)
    for slot in range(sk):
        u5 = uniforms[slot]
        idx = torch.clamp_max((u5[0] * num_lights).int(), num_lights - 1)
        comps = sample_lights_planes(lights, idx, u5[1], u5[2],
                                     gather=gather_rows_plain)
        p_hat = target_pdf_planes(ctx, *comps, features)
        w = p_hat * float(num_lights) * real_all[slot][:, None, None]
        log_w = torch.log(torch.clamp_min(w, 1e-37))
        iuv = (idx.float(), u5[1], u5[2])
        w_sum = w_sum + w
        for race in range(2):
            score = torch.where(w > 0.0,
                                log_w + _gumbel_from_uniform(u5[3 + race]),
                                -torch.inf)
            upd = score > best[race]
            best[race] = torch.where(upd, score, best[race])
            rec[race] = [torch.where(upd, a, b)
                         for a, b in zip(iuv, rec[race])]
    return w_sum, tuple(rec[0]), tuple(rec[1])


def surrogate_tail(ctx: ShadeCtx, lights, num_lights: int, features: Features,
                   w_sum, replay1, replay2, geometry=None, any_hit=None,
                   gather=None):
    """The differentiable reservoir from detached replay records (reference
    ``ops/wrs._surrogate_tail``) → (Reservoirs, records [K, 3, H, W]).

    The winner's light sample is re-derived from its record (one row gather
    of the light table per race, through ``gather``); w_sum keeps its
    detached value, and its gradient is the second race's single-sample
    estimate stopgrad(w_sum / w_J') d w_J'."""
    from ..scene.lights import sample_lights_planes

    h, w_img = ctx.depth_t.shape[-2:]
    k = features.num_samples_in_reservoir
    _, lane_counts, _ = _lane_layout(features.initial_light_samples, k)
    w_sum = w_sum.detach()
    has = w_sum > 0.0

    def reeval(iuv):
        idxf, u1, u2 = (a.detach() for a in iuv)
        comps = sample_lights_planes(lights, idxf.int(), u1, u2,
                                     gather=gather)
        return comps, target_pdf_planes(ctx, *comps, features)

    comps1, p_hat1 = reeval(replay1)
    _, p_hat2 = reeval(replay2)
    w2 = p_hat2 * float(num_lights)
    w2_d = w2.detach()
    ok2 = w2_d > 0.0
    ratio = torch.where(ok2, w_sum / torch.where(ok2, w2_d, 1.0), 0.0)
    w_sum_diff = w_sum + ratio * (w2 - w2_d)

    def mask(a):
        return torch.where(has, a, 0.0)

    sel_pos = torch.stack([mask(c) for c in comps1[0:3]], dim=1)
    sel_color = torch.stack([mask(c) for c in comps1[3:6]], dim=1)
    sel_p_hat = mask(p_hat1)
    m = torch.as_tensor(lane_counts, device=w_sum.device)[:, None, None] \
        .expand(k, h, w_img).contiguous()
    big_w = _safe_big_w(w_sum_diff, sel_p_hat, m, sel_p_hat > 0.0)
    if features.initial_samples_visibility_check:
        vis = visibility(ctx.position, sel_pos, geometry, any_hit)
        big_w = torch.where(vis, big_w, 0.0)
    res = Reservoirs(pos=sel_pos, color=sel_color, w_sum=w_sum_diff, m=m,
                     big_w=big_w, chosen_w=sel_p_hat * float(num_lights))
    idxf, u1, u2 = (a.detach() for a in replay1)
    rec = torch.stack([torch.where(has, idxf, -1.0), u1, u2], dim=1)
    return res, rec


def gen_canonical_surrogate(ctx: ShadeCtx, lights, num_lights: int, geometry,
                            features: Features, generator=None, uniforms=None,
                            replay=None, gather=None, any_hit=None,
                            row_base: int = 0, h_global=None):
    """gen_canonical_samples with the winner-replay surrogate gradient
    (reference ``ops/wrs._gen_canonical_surrogate`` and
    ``gen_canonical_with_records``) → (Reservoirs, replay records
    [K, 3, H, W]). The candidate loop runs detached through ``replay``
    (kernel 14 by default: the plain version for CPU tensors; ``uniforms``
    [S/K, 5, K, H, W] is its test hook; ``row_base`` and ``h_global`` a
    row band's, ``ops.band``), then ``surrogate_tail`` re-derives the
    reservoir differentiably."""
    from .ris import gen_canonical_replay
    from .rows import gather_rows
    from .trace import any_hit as any_hit_kernel

    replay = replay or gen_canonical_replay
    band = {} if h_global is None else dict(row_base=row_base,
                                            h_global=h_global)
    w_sum, replay1, replay2 = replay(
        detached(ctx), detached(lights), num_lights, features,
        generator=generator, uniforms=uniforms, **band)
    return surrogate_tail(ctx, lights, num_lights, features, w_sum, replay1,
                          replay2, geometry, any_hit or any_hit_kernel,
                          gather or gather_rows)


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
    w_sum = w.sum(dim=0)
    m_out = torch.where(in_mask[:, None], inputs.m, 0.0).sum(dim=0)
    return (_select(inputs.pos, win), _select(inputs.color, win),
            _select(w, win), _select(p_hat, win), w_sum, m_out, win)


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-37)))


def _select(a: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """The R-way masked select of input ``win`` [K, H, W] from a
    [R, K, (3,) H, W] stack, differentiable into the winning input."""
    win_b = win if a.dim() == 4 else win[:, None]
    out = torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device)
    for i in range(a.shape[0]):
        out = torch.where(win_b == i, a[i], out)
    return out


def no_record(rec: torch.Tensor) -> torch.Tensor:
    """Records [..., 3, H, W] with the light index set to -1."""
    return torch.cat([torch.full_like(rec[..., :1, :, :], -1.0),
                      rec[..., 1:, :, :]], dim=-3)


def combine_biased(receiver: ShadeCtx, inputs: Reservoirs, in_mask,
                   features: Features, gumbel: torch.Tensor, records=None):
    """ReSTIR Algorithm 5: re-weight every input sample by
    p_hat_receiver·W·M, resample one winner per lane with the race noise
    ``gumbel`` [R, K, H, W], then W = wSum / (p_hat(winner)·M_total).

    With replay ``records`` [R, K, 3, H, W] it returns (Reservoirs, the
    winner's record [K, 3, H, W]), the index -1 where no input won."""
    w, p_hat = _stream_weights(receiver, inputs, in_mask, features)
    sel_pos, sel_color, sel_w, sel_p_hat, w_sum, m_out, win = \
        _select_lanewise(gumbel, w, p_hat, inputs, in_mask)
    big_w = _safe_big_w(w_sum, sel_p_hat, m_out,
                        (sel_p_hat > 0.0) & (m_out > 0.0))
    res = Reservoirs(pos=sel_pos, color=sel_color, w_sum=w_sum, m=m_out,
                     big_w=big_w, chosen_w=sel_w)
    if records is None:
        return res
    rec = _select(records, win)
    won = (sel_w.detach() > 0.0)[:, None]
    return res, torch.where(won, rec, no_record(rec))


def combine_biased_surrogate(receiver: ShadeCtx, inputs: Reservoirs, in_mask,
                             features: Features, gumbel: torch.Tensor,
                             gumbel2: torch.Tensor, records=None, lights=None,
                             gather=None):
    """combine_biased with the winner-replay surrogate gradient (reference
    ``ops/wrs.combine_biased_surrogate``): the R x K stream weights and both
    races (``gumbel``, the same draw as combine_biased, and ``gumbel2``,
    each [R, K, H, W]) run detached; the winner's w and p_hat are
    re-evaluated differentiably, and d(w_sum) comes from the second race's
    single sample. Every output value equals combine_biased's.

    With ``records`` [R, K, 3, H, W] (light index | u | v, -1 for none) the
    winners' position and colour are re-derived from the records against
    ``lights`` through ``gather`` (inputs without one keep their detached
    planes), and the result is (Reservoirs, records [K, 3, H, W])."""
    from ..scene.lights import sample_lights_planes

    in_d = detached(inputs)
    w_d, p_hat_d = _stream_weights(detached(receiver), in_d, in_mask,
                                   features)
    log_w = torch.log(torch.clamp_min(w_d, 1e-37))
    win1 = torch.argmax(torch.where(w_d > 0.0, log_w + gumbel, -torch.inf),
                        dim=0)
    win2 = torch.argmax(torch.where(w_d > 0.0, log_w + gumbel2, -torch.inf),
                        dim=0)

    def pdf(pos, color):
        return target_pdf_planes(
            receiver, pos[:, 0], pos[:, 1], pos[:, 2], color[:, 0],
            color[:, 1], color[:, 2], features)

    def winner(win):
        """The winning sample's (position, colour), re-derived from its
        replay record where it has one."""
        if records is None:
            return _select(inputs.pos, win), _select(inputs.color, win)
        rec = _select(records, win)
        idxf, u1, u2 = rec[:, 0], rec[:, 1], rec[:, 2]
        has = (idxf >= 0.0)[:, None]
        comps = sample_lights_planes(lights, torch.clamp_min(idxf, 0.0).int(),
                                     u1, u2, gather=gather)
        return (torch.where(has, torch.stack(comps[0:3], dim=1),
                            _select(in_d.pos, win)),
                torch.where(has, torch.stack(comps[3:6], dim=1),
                            _select(in_d.color, win)))

    sel_pos, sel_color = winner(win1)
    sel_p_hat = pdf(sel_pos, sel_color)
    won = _select(w_d, win1) > 0.0
    sel_w = torch.where(won, sel_p_hat * _select(inputs.big_w, win1)
                        * _select(inputs.m, win1), 0.0)
    sel_p_hat = torch.where(won, sel_p_hat, _select(p_hat_d, win1))

    w_sum_d = w_d.sum(dim=0)
    w2 = pdf(*winner(win2)) * _select(inputs.big_w, win2) \
        * _select(inputs.m, win2)
    w2_d = w2.detach()
    ok2 = w2_d > 0.0
    ratio = torch.where(ok2, w_sum_d / torch.where(ok2, w2_d, 1.0), 0.0)
    w_sum = w_sum_d + ratio * (w2 - w2_d)

    m_out = torch.where(in_mask[:, None], inputs.m, 0.0).sum(dim=0)
    big_w = _safe_big_w(w_sum, sel_p_hat, m_out,
                        (sel_p_hat.detach() > 0.0) & (m_out > 0.0))
    res = Reservoirs(pos=sel_pos, color=sel_color, w_sum=w_sum, m=m_out,
                     big_w=big_w, chosen_w=sel_w)
    if records is None:
        return res
    rec1 = _select(records, win1)
    return res, torch.where(won[:, None], rec1, no_record(rec1))


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
    sel_pos, sel_color, sel_w, sel_p_hat, w_sum, m_out, _ = _select_lanewise(
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
