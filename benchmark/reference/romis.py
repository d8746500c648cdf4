"""The plain reference of the R-OMIS direct frame (reservoir-based optimal
multiple importance sampling; the reference renderer's renderROMIS,
``src/render/render.cpp:121-265``), written apart from the program, on
the ReSTIR reference's rays, hits, shading and RIS (``restir``).

For the settings this benchmark drives: direct (not progressive), the
SIMILAR neighbour strategy, a triangle soup.

1. Neighbours, once a frame: every in-image cell of the ±radius box
   (self excluded; dy-major, dx-minor) scores its Gumbel noise, plus 1e6
   in float32 where it is similar (the same surface, the pixel's depth
   within 10 % of the cell's, normals within 25°); the D best scores, ties
   to the earlier cell, are the neighbours; an empty slot takes the pixel
   itself.
2. Each iteration draws fresh canonical reservoirs at every pixel (RIS,
   as ReSTIR's), and every pixel takes the D+1 reservoirs of itself and
   its neighbours (member j = 0 is the pixel). Each sample (member d,
   lane k) is shaded at the pixel (Phong, times its shadow ray's
   visibility) and weighed under every member j's context:
   W'_j = (1/p̂_j)(1/M)(wSum_j − chosenW_j + p̂_j·L), wSum and chosenW of
   member j's reservoir in the same lane, p̂_j the sample's target at
   member j (0 where p̂_j ≤ 1e-18); colvec_j = 1/W'_j (0 where |W'_j| ≤
   1e-37); scale = 1/(FLT_MIN + K·Σ_j colvec_j) (1/FLT_MIN where that sum
   is under 1e-30); ŵ = scale·colvec; A += ŵŵᵀ and b_c += scale·ŵ·f_c
   over the samples.
3. After the iterations, α = (A + λI)⁻¹ b per channel by a Cholesky
   factorisation whose pivots are floored at λ = 1e-6·tr(A)/(D+1) + 1e-20
   (non-finite α become 0); the pixel is Σ_j α_j, tone mapped.
"""

from __future__ import annotations

import math

import torch

from harness.scenedata import load

from . import philox, restir
from .precision import lower_precision

FLT_MIN = 1.17549435e-38
CLASS_OFFSET = 1e6

REQUIRED = {
    "ray_trace_mode": "romis", "enable_shading": True,
    "initial_samples_visibility_check": False,
    "use_progressive_romis": False, "neighbour_selection_strategy": "similar",
    "fused_resampling": True, "fused_spatial_gather": True,
    "surrogate_resampling_grad": False,
}


def settings(config: dict, traffic: dict) -> dict:
    f = {**config["features"], **traffic.get("features", {})}
    for k, v in REQUIRED.items():
        if f.get(k) != v:
            raise ValueError(f"the R-OMIS reference models {k}={v!r}, the "
                             f"cell sets {f.get(k)!r}")
    return f


def box(radius: int) -> list:
    return [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1) if (dy, dx) != (0, 0)]


def neighbours(r: restir.Receivers, h: int, w: int, f: dict, scores):
    """The D neighbours of every pixel → pixel indices [D, N]. ``scores``
    [cells, N] is the noise of each box cell."""
    d, radius = f["num_neighbours_to_sample"], f["spatial_resample_radius"]
    frac = torch.tensor(f["neighbour_max_depth_difference_fraction"],
                        dtype=torch.float32)
    cos = torch.tensor(math.cos(
        f["neighbour_max_normal_angle_difference_radians"]),
        dtype=torch.float32)
    n = h * w
    dev = r.depth.device
    pix = torch.arange(n, device=dev)
    row, col = pix // w, pix % w
    best_s = torch.full((d, n), -math.inf, device=dev)
    best_q = pix[None].expand(d, n).clone()
    for o, (dy, dx) in enumerate(box(radius)):
        ny, nx = row + dy, col + dx
        inside = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        q = ny.clamp(0, h - 1) * w + nx.clamp(0, w - 1)
        similar = (torch.abs(1.0 - r.depth / torch.clamp_min(r.depth[q],
                                                              1e-20))
                   <= frac.to(dev)) & (
            restir._dot(r.normal, r.normal[:, q]) >= cos.to(dev))
        if f["neighbour_same_geometry"]:
            similar = similar & (r.geometry[q] == r.geometry)
        s = torch.where(inside, torch.where(similar, scores[o] + CLASS_OFFSET,
                                            scores[o]), -math.inf)
        # Insert after every kept score at least as large (ties: earlier).
        all_s = torch.cat([best_s, s[None]])
        all_q = torch.cat([best_q, q[None]])
        order = torch.sort(all_s, dim=0, descending=True, stable=True).indices
        best_s = torch.gather(all_s, 0, order[:d])
        best_q = torch.gather(all_q, 0, order[:d])
    return torch.where(torch.isfinite(best_s), best_q, pix[None])


class Members:
    """The receivers' fields at the neighbourhood members' pixels."""

    def __init__(self, r: restir.Receivers, idx):
        self.pos, self.normal = r.pos[:, idx], r.normal[:, idx]
        self.view, self.kd, self.ks = r.view[:, idx], r.kd[:, idx], \
            r.ks[:, idx]
        self.shininess, self.valid = r.shininess[idx], r.valid[idx]


def iteration(r: restir.Receivers, soup: restir.Soup, res: dict, members,
              n_lights: int, lane_m):
    """One iteration's (A upper [D1(D1+1)/2, N], b [3, D1, N])."""
    idx = torch.cat([torch.arange(r.depth.shape[0],
                                  device=r.depth.device)[None], members])
    d1 = idx.shape[0]
    k = res["m"].shape[0]
    pos = torch.stack([res["pos"][..., q] for q in idx])  # [D1, K, 3, N]
    col = torch.stack([res["col"][..., q] for q in idx])
    w_sum = torch.stack([res["w_sum"][..., q] for q in idx])  # [D1, K, N]
    chosen = torch.stack([res["chosen_w"][..., q] for q in idx])
    rgb = restir.phong(r, pos, col)
    p_recv = restir._norm(rgb)
    vis = torch.stack([torch.stack([
        _visible(r, soup, pos[d, lane]) for lane in range(k)])
        for d in range(d1)])
    f = torch.where(vis[:, :, None], rgb, 0.0)  # [D1, K, 3, N]
    colvec = []
    for j in range(d1):
        p_j = p_recv if j == 0 else restir.p_hat(Members(r, idx[j]), pos,
                                                 col)
        ok_p = p_j > 1e-18
        inv_p = torch.where(ok_p, 1.0 / torch.where(ok_p, p_j, 1.0), 0.0)
        w_prime = (inv_p * (1.0 / lane_m)[:, None]) * (
            (w_sum[j] - chosen[j]) + p_j * float(n_lights))
        ok_w = ok_p & (w_prime.abs() > 1e-37)
        colvec.append(torch.where(ok_w, 1.0 / torch.where(ok_w, w_prime, 1.0),
                                  0.0))
    s_cv = colvec[0]
    for j in range(1, d1):
        s_cv = s_cv + colvec[j]
    ok_s = s_cv >= 1e-30
    scale = torch.where(ok_s, 1.0 / torch.where(
        ok_s, FLT_MIN + float(k) * s_cv, 1.0), 1.0 / FLT_MIN)
    w_hat = torch.stack(colvec) * scale  # [J, D1, K, N]
    a_up = []
    for i in range(d1):
        for j in range(i, d1):
            a_up.append(_sample_sum(w_hat[i] * w_hat[j]))
    ws = w_hat * scale
    b = torch.stack([torch.stack([_sample_sum(ws[j] * f[:, :, c])
                                  for j in range(d1)]) for c in range(3)])
    return torch.stack(a_up), b


def _visible(r, soup, target):
    """The shadow ray from the receiver to ``target`` [3, N] is clear."""
    to = target - r.pos
    dist = restir._norm(to)
    d = to * (1.0 / torch.clamp_min(dist, 1e-20))
    o = r.pos + restir.SHADOW_EPS * d
    return ~soup.occluded(o, d, restir._norm(target - o)) \
        | (dist <= restir.SHADOW_EPS)


def _sample_sum(x):
    """Σ over the samples (member-major, then lane) of x [D1, K, N]."""
    out = torch.zeros_like(x[0, 0])
    for d in range(x.shape[0]):
        for lane in range(x.shape[1]):
            out = out + x[d, lane]
    return out


def solve(a_up, b):
    """α [3, D1, N] of (A + λI) α = b, A from its upper triangle."""
    d1 = b.shape[1]
    a = [[None] * d1 for _ in range(d1)]
    u = 0
    for i in range(d1):
        for j in range(i, d1):
            a[i][j] = a[j][i] = a_up[u]
            u += 1
    tr = a[0][0]
    for i in range(1, d1):
        tr = tr + a[i][i]
    lam = 1e-6 * tr / d1 + 1e-20

    def dot(pairs):
        acc = torch.zeros_like(lam)
        for x, y in pairs:
            acc = acc + x * y
        return acc

    low = [[None] * d1 for _ in range(d1)]
    inv = [None] * d1
    for j in range(d1):
        low[j][j] = torch.sqrt(torch.maximum(
            (a[j][j] + lam) - dot((low[j][q], low[j][q]) for q in range(j)),
            lam))
        inv[j] = 1.0 / low[j][j]
        for i in range(j + 1, d1):
            low[i][j] = (a[i][j] - dot((low[i][q], low[j][q])
                                       for q in range(j))) * inv[j]
    out = []
    for c in range(3):
        y = [None] * d1
        for i in range(d1):
            y[i] = (b[c, i] - dot((low[i][q], y[q]) for q in range(i))) \
                * inv[i]
        x = [None] * d1
        for i in reversed(range(d1)):
            x[i] = (y[i] - dot((low[q][i], x[q])
                               for q in range(i + 1, d1))) * inv[i]
        out.append(torch.stack(x))
    alpha = torch.stack(out)
    return torch.where(torch.isfinite(alpha), alpha, 0.0)


class CardDraws:
    """The program's draws on the card, in its order: the selection
    kernel's key (one int64 from the generator), then the MIS RIS kernel's
    (one int64, read back); their numbers from the kernels' Philox
    streams."""

    def __init__(self, seed: int, dev):
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.dev = dev

    def frame(self, f: dict, h: int, w: int):
        g, dev, n = self.gen, self.dev, h * w
        k = f["num_samples_in_reservoir"]
        sel_key = int(torch.randint(0, 2 ** 62, (1,), generator=g,
                                    dtype=torch.int64, device=dev)[0])
        scores = philox.selection_scores(
            sel_key, len(box(f["spatial_resample_radius"])), n, dev)
        mis_key = int(torch.randint(0, 2 ** 62, (), generator=g, device=dev))

        def slots(it):
            return lambda t: philox.ris_slot(mis_key, t, k, n, dev,
                                             philox.TAG_MIS | it)

        return scores, slots


class HostDraws:
    """The program's draws on the CPU: the selection's Gumbel noise, then
    each iteration's RIS uniforms, from the generator."""

    def __init__(self, seed: int, dev):
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.dev = dev

    def frame(self, f: dict, h: int, w: int):
        g, dev, n = self.gen, self.dev, h * w
        k, s = f["num_samples_in_reservoir"], f["initial_light_samples"]
        cells = len(box(f["spatial_resample_radius"]))
        scores = restir._gumbel(torch.rand((cells, h, w), generator=g,
                                           device=dev)).reshape(cells, n)
        u = [torch.rand((-(-s // k), 4, k, h, w), generator=g,
                        device=dev).reshape(-1, 4, k, n)
             for _ in range(f["max_iterations_mis"])]

        def slots(it):
            return lambda t: tuple(u[it][t, c] for c in range(4))

        return scores, slots


@torch.no_grad()
def expected(config: dict, traffic: dict, seed: int, device, n: int,
             size=None, control: bool = False) -> list:
    """The cell's first ``n`` frames → [H, W, 3] float32 images on the
    CPU; ``control`` as in ``restir.expected``."""
    f = settings(config, traffic)
    d = load(config, size)
    dev = torch.device(device)
    h, w = d.height, d.width
    draws = (CardDraws if dev.type == "cuda" else HostDraws)(seed, dev)
    with lower_precision(control):
        soup, lights = restir.Soup(d, dev), restir.Lights(d, dev)
        r = restir.Receivers(soup, *restir.primary_rays(d, dev))
    k, s = f["num_samples_in_reservoir"], f["initial_light_samples"]
    sk = -(-s // k)
    lane_m = torch.tensor([float(sum(t * k + lane < s for t in range(sk)))
                           for lane in range(k)], device=dev)
    out = []
    for _ in range(n):
        scores, slots = draws.frame(f, h, w)
        with lower_precision(control):
            members = neighbours(r, h, w, f, scores)
            a_up, b = 0.0, 0.0
            for it in range(f["max_iterations_mis"]):
                res = restir.ris(r, lights, s, k, slots(it))
                da, db = iteration(r, soup, res, members, lights.n, lane_m)
                a_up, b = a_up + da, b + db
            color = solve(a_up, b).sum(dim=1)
            if f["enable_tone_mapping"]:
                color = 1.0 - torch.exp(-float(f["exposure"]) * color)
                color = torch.pow(torch.clamp_min(color, 0.0),
                                  1.0 / float(f["gamma"]))
        out.append(color.reshape(3, h, w).permute(1, 2, 0).float().cpu())
    return out


numbers = restir.numbers


@torch.no_grad()
def context(config: dict, traffic: dict, device, size=None) -> dict:
    """The cell's sizes for the per-layer readers, and the pixels whose
    primary ray hits the scene."""
    f = settings(config, traffic)
    d = load(config, size)
    dev = torch.device(device)
    r = restir.Receivers(restir.Soup(d, dev), *restir.primary_rays(d, dev))
    return {"pixels": d.height * d.width,
            "hit_pixels": int(r.valid.sum()),
            "candidates": f["initial_light_samples"],
            "lanes": f["num_samples_in_reservoir"],
            "neighbours": f["num_neighbours_to_sample"],
            "triangles": int(d.tris.shape[0])}
