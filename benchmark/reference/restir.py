"""The plain reference of the spatiotemporal ReSTIR frame, written apart
from the program, in plain PyTorch on flat pixel arrays.

What it computes is the renderer's documented frame (the reference
renderer MrMagnifico/romis, ``src/render/render_utils.cpp``, and the
contracts in the program's kernel sources), for the settings this
benchmark drives: biased reuse, no initial visibility check, a still
camera, a triangle soup (no BVH), Phong shading without textures.

1. Primary rays through pixel corners: x = 2j/W - 1, y = 2(H-1-i)/H - 1,
   camera direction (-x·tan(fov/2)·aspect, y·tan(fov/2), 1) normalised,
   rotated by the XYZ Euler quaternion; the origin is
   look_at + R·(0, 0, -distance).
2. Closest hit by Möller-Trumbore against every triangle (|det| > 1e-9,
   t > 0, u, v >= 0, u + v <= 1), the lowest index on a tie in t.
3. RIS: S candidates a pixel over K lanes (candidate j = slot·K + lane);
   a uniform light pick, a point v0 + u·e01 + v·e02 with the bilinear
   colour of its corners, target p̂ = |Phong| (diffuse and specular over
   the squared distance, 0 behind the surface), weight w = p̂·L, and a
   race per lane won by the largest w / E, E = -log(u) + 1e-37; the lane's
   W = Σw / (p̂(winner)·M), M the lane's candidates.
4. Temporal reuse: the previous frame's reservoirs at the same pixel, M
   clamped to 20·M(current) + 1 (each lane's Σw scaled with it), then a
   biased combine of {current, previous}.
5. Spatial reuse, biased: per pass R neighbours at offsets uniform in
   ±radius, clamped to the screen; a neighbour counts where both pixels
   are valid, its depth is within 10 % and its normal within 25° of the
   receiver's; the combine of {neighbours..., self}.
   A combine: each input lane's sample re-weighted at the receiver by
   p̂·W·M; per lane a Gumbel-max race (log w + G, the first maximum wins,
   input 0 where no weight is positive); W = Σw / (p̂(winner)·ΣM).
6. Final shade: per lane the shadow ray from the hit point (offset 1e-3
   toward the sample, to the sample), Phong·W where it is unoccluded; the
   mean over the lanes; then 1 - exp(-exposure·c) and the gamma.

The random numbers are the program's, made again from the seed (see
``CardDraws`` and ``HostDraws``).
"""

from __future__ import annotations

import math

import torch

from harness.scenedata import load

from . import philox
from .precision import lower_precision

MT_EPS = 1e-9
SHADOW_EPS = 1e-3
ZERO_EPS = 1e-5
DEPTH_FRAC = 0.1
NORMAL_COS = math.cos(math.radians(25.0))

# The settings the reference models, each as the frame must have it.
REQUIRED = {
    "ray_trace_mode": "restir", "enable_shading": True,
    "initial_samples_visibility_check": False,
    "temporal_reprojection": False, "unbiased_combination": False,
    "spatial_reuse_visibility_check": False,
    "surrogate_resampling_grad": False, "coherent_spatial_offsets": False,
    "fused_resampling": True, "fused_spatial_gather": True,
}


def settings(config: dict, traffic: dict) -> dict:
    f = {**config["features"], **traffic.get("features", {})}
    for k, v in REQUIRED.items():
        if f.get(k) != v:
            raise ValueError(f"the ReSTIR reference models {k}={v!r}, the "
                             f"cell sets {f.get(k)!r}")
    return f


# ---------------------------------------------------------------- geometry

def _dot(a, b):
    return a[..., 0, :] * b[..., 0, :] + a[..., 1, :] * b[..., 1, :] \
        + a[..., 2, :] * b[..., 2, :]


def _cross(a, b):
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-2)


def _norm(a):
    sq = _dot(a, a)
    return torch.where(sq > 1e-30, torch.sqrt(torch.clamp_min(sq, 1e-30)),
                       0.0)


def _quat(euler):
    """The XYZ Euler angles' quaternion (w, x, y, z)."""
    c, s = torch.cos(euler * 0.5), torch.sin(euler * 0.5)
    return torch.stack([
        c[0] * c[1] * c[2] + s[0] * s[1] * s[2],
        s[0] * c[1] * c[2] - c[0] * s[1] * s[2],
        c[0] * s[1] * c[2] + s[0] * c[1] * s[2],
        c[0] * c[1] * s[2] - s[0] * s[1] * c[2]])


def _rotate(q, v):
    """v [3, N] rotated by q: v + 2w(q×v) + 2q×(q×v)."""
    qv = q[1:, None].expand(v.shape)
    t = 2.0 * _cross(qv, v)
    return v + q[0] * t + _cross(qv, t)


def primary_rays(d, dev):
    """→ (origin [3], directions [3, N])."""
    f32 = dict(dtype=torch.float32, device=dev)
    look_at = torch.tensor(d.look_at, **f32)
    q = _quat(torch.deg2rad(torch.tensor(d.rotation_deg, **f32)))
    back = torch.tensor([0.0, 0.0, -1.0], **f32) * torch.tensor(d.distance,
                                                                 **f32)
    origin = look_at + _rotate(q, back[:, None])[:, 0]
    half_h = torch.tan(torch.deg2rad(torch.tensor(d.fov_y_deg, **f32)) * 0.5)
    half_w = torch.tensor(d.width / d.height, **f32) * half_h
    h, w = d.height, d.width
    x = torch.arange(w, **f32) / w * 2.0 - 1.0
    y = (h - 1 - torch.arange(h, **f32)) / h * 2.0 - 1.0
    x, y = x[None, :].expand(h, w).reshape(-1), y[:, None].expand(h, w) \
        .reshape(-1)
    cam = torch.stack([-x * half_w, y * half_h, torch.ones_like(x)])
    cam = cam * (1.0 / torch.clamp_min(_norm(cam), 1e-20))
    return origin, _rotate(q, cam)


class Soup:
    """The triangles as [T, 3] columns on the device."""

    def __init__(self, d, dev):
        t = torch.as_tensor(d.tris, device=dev)
        self.v0, self.e1, self.e2 = t[:, 0], t[:, 1] - t[:, 0], \
            t[:, 2] - t[:, 0]
        self.normal = torch.as_tensor(d.normals, device=dev)
        mat = torch.as_tensor(d.material, device=dev).long()
        self.kd = torch.as_tensor(d.kd, device=dev)[mat]
        self.ks = torch.as_tensor(d.ks, device=dev)[mat]
        self.shininess = torch.as_tensor(d.shininess, device=dev)[mat]
        self.geometry = torch.as_tensor(d.geometry, device=dev).long()

    def __len__(self):
        return self.v0.shape[0]

    def hit(self, i: int, o, dirs):
        """Möller-Trumbore of rays (o [3, ...] broadcast, dirs [3, M])
        against triangle i → (t, u, v, ok)."""
        v0, e1, e2 = (a[i][:, None] for a in (self.v0, self.e1, self.e2))
        p = _cross(dirs, e2.expand(dirs.shape))
        det = _dot(e1.expand(dirs.shape), p)
        ok = det.abs() > MT_EPS
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        tv = (o - v0).expand(dirs.shape)
        u = _dot(tv, p) * inv
        qv = _cross(tv, e1.expand(dirs.shape))
        v = _dot(dirs, qv) * inv
        t = _dot(e2.expand(dirs.shape), qv) * inv
        ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
            & (t > 0.0)
        return t, u, v, ok

    def closest(self, o, dirs):
        """→ (t [M], inf on a miss; triangle [M], -1 on a miss)."""
        best = torch.full(dirs.shape[1:], math.inf, device=dirs.device)
        tri = torch.full(dirs.shape[1:], -1, dtype=torch.int64,
                         device=dirs.device)
        for i in range(len(self)):
            t, _, _, ok = self.hit(i, o, dirs)
            better = ok & (t < best)
            best = torch.where(better, t, best)
            tri = torch.where(better, i, tri)
        return best, tri

    def occluded(self, o, dirs, t_max):
        """A triangle at t in (0, t_max) on each ray → bool [M]."""
        occ = torch.zeros(dirs.shape[1:], dtype=torch.bool,
                          device=dirs.device)
        for i in range(len(self)):
            t, _, _, ok = self.hit(i, o, dirs)
            occ = occ | (ok & (t < t_max))
        return occ


class Receivers:
    """Every pixel's primary hit: position, normal, material, view."""

    def __init__(self, soup: Soup, origin, dirs):
        t, tri = soup.closest(origin[:, None], dirs)
        self.valid = torch.isfinite(t)
        self.depth = torch.where(self.valid, t, 0.0)
        idx = tri.clamp_min(0)
        self.pos = origin[:, None] + self.depth * dirs
        live = self.valid[None]
        self.normal = torch.where(live, soup.normal[idx].T, 0.0)
        self.kd = soup.kd[idx].T
        self.ks = soup.ks[idx].T
        self.shininess = soup.shininess[idx]
        self.geometry = torch.where(self.valid, soup.geometry[idx], -1)
        view = origin[:, None] - self.pos
        self.view = view * (1.0 / torch.clamp_min(_norm(view), 1e-20))


# ---------------------------------------------------------------- shading

def _scrub(x):
    return torch.where(torch.isnan(x), 0.0, x)


def phong(r: Receivers, lpos, lcol):
    """The receiver's Phong term for lights at lpos [..., 3, N] of colour
    lcol → [..., 3, N]."""
    to = lpos - r.pos
    dist = torch.sqrt(torch.clamp_min(_dot(to, to), 1e-24))
    ldir = to * (1.0 / torch.clamp_min(dist, 1e-20))[..., None, :]
    cos_nl = _dot(r.normal, ldir)
    refl = 2.0 * cos_nl[..., None, :] * r.normal - ldir
    cos_rv = _dot(refl, r.view) * (1.0 / torch.clamp_min(_norm(refl),
                                                         1e-20))
    spec = torch.where(cos_rv > 0.0,
                       torch.pow(torch.clamp_min(cos_rv, 1e-12),
                                 r.shininess), 0.0)
    falloff = torch.where(dist < ZERO_EPS, 1.0, dist)
    inv_f2 = 1.0 / (falloff * falloff)
    out = (_scrub(lcol * r.kd * cos_nl[..., None, :])
           + _scrub(lcol * r.ks * spec[..., None, :])) * inv_f2[..., None, :]
    dead = (cos_nl < 0.0) | ~r.valid
    return torch.where(dead[..., None, :], 0.0, out)


def p_hat(r: Receivers, lpos, lcol):
    return _norm(phong(r, lpos, lcol))


# ---------------------------------------------------------------- reservoirs

class Lights:
    def __init__(self, d, dev):
        rows = torch.as_tensor(d.lights, device=dev)  # [L, 7, 3]
        self.rows, self.n = rows, rows.shape[0]

    def sample(self, idx, u, v):
        """Points and colours of lights idx [K, N] at (u, v) → [K, 3, N]
        each."""
        q = self.rows[idx].movedim(-1, -2)  # [K, N, 7, 3] → [K, N, 3, 7]
        q = q.movedim(1, -1)  # [K, 3, 7, N]
        u, v = u[:, None], v[:, None]
        pos = q[:, :, 0] + u * q[:, :, 1] + v * q[:, :, 2]
        col = (q[:, :, 3] * (1.0 - u) + q[:, :, 4] * u) * (1.0 - v) \
            + (q[:, :, 5] * (1.0 - u) + q[:, :, 6] * u) * v
        return pos, col


def ris(r: Receivers, lights: Lights, s: int, k: int, slot_draws):
    """S candidates over K lanes → reservoir fields (pos, col [K, 3, N];
    w_sum, m, big_w, chosen_w (the winner's w) [K, N]). ``slot_draws(t)`` gives slot t's (pick, u, v,
    race), each [K, N]."""
    n = r.depth.shape[0]
    dev = r.depth.device
    w_sum = torch.zeros((k, n), device=dev)
    best = torch.full((k, n), -math.inf, device=dev)
    pos = torch.zeros((k, 3, n), device=dev)
    col = torch.zeros((k, 3, n), device=dev)
    ph_sel = torch.zeros((k, n), device=dev)
    w_sel = torch.zeros((k, n), device=dev)
    sk = -(-s // k)
    real = torch.tensor([[t * k + lane < s for lane in range(k)]
                         for t in range(sk)], device=dev)
    for t in range(sk):
        pick, u, v, race = slot_draws(t)
        idx = torch.clamp_max((pick * lights.n).to(torch.int64),
                              lights.n - 1)
        lp, lc = lights.sample(idx, u, v)
        ph = p_hat(r, lp, lc)
        w = torch.where(real[t][:, None], ph * float(lights.n), 0.0)
        e = -torch.log(torch.clamp_min(race, 1e-37)) + 1e-37
        score = torch.where(w > 0.0, w / e, -math.inf)
        take = score > best
        w_sum = w_sum + w
        best = torch.where(take, score, best)
        pos = torch.where(take[:, None], lp, pos)
        col = torch.where(take[:, None], lc, col)
        ph_sel = torch.where(take, ph, ph_sel)
        w_sel = torch.where(take, w, w_sel)
    m = real.sum(dim=0).to(torch.float32)[:, None].expand(k, n)
    big_w = torch.where(ph_sel > 0.0,
                        w_sum / torch.where(ph_sel > 0.0, ph_sel * m, 1.0),
                        0.0)
    return {"pos": pos, "col": col, "w_sum": w_sum, "m": m.clone(),
            "big_w": big_w, "chosen_w": w_sel}


def combine(r: Receivers, inputs: list, masks, noise):
    """The biased combine of input reservoirs (each field [K, ...]) whose
    masks [I, N] say which count at each pixel, with race noise
    [I, K, N]."""
    pos = torch.stack([x["pos"] for x in inputs])  # [I, K, 3, N]
    col = torch.stack([x["col"] for x in inputs])
    m = torch.stack([x["m"] for x in inputs])  # [I, K, N]
    big_w = torch.stack([x["big_w"] for x in inputs])
    ph = p_hat(r, pos, col)
    w = torch.where(masks[:, None], ph * big_w * m, 0.0)
    score = torch.where(w > 0.0, torch.log(torch.clamp_min(w, 1e-37))
                        + noise, -math.inf)
    win = torch.argmax(score, dim=0)  # [K, N], the first maximum

    def pick(a):
        ix = win[None]
        if a.dim() == 4:
            return torch.gather(a, 0, ix[:, :, None].expand(
                (1,) + a.shape[1:]))[0]
        return torch.gather(a, 0, ix)[0]

    w_sum = w[0]
    for i in range(1, w.shape[0]):
        w_sum = w_sum + w[i]
    m_out = torch.where(masks[:, None], m, 0.0).sum(dim=0)
    ph_win = pick(ph)
    ok = (ph_win > 0.0) & (m_out > 0.0)
    big = torch.where(ok, w_sum / torch.where(ok, ph_win * m_out, 1.0), 0.0)
    return {"pos": pick(pos), "col": pick(col), "w_sum": w_sum, "m": m_out,
            "big_w": big}


def clamp_history(prev: dict, current: dict, clamp: float) -> dict:
    """M-clamping of the previous frame's reservoirs."""
    bound = clamp * current["m"].sum(dim=0) + 1.0  # [N]
    over = (prev["m"].sum(dim=0) > bound)[None] & (prev["m"] > 0.0)
    scale = bound[None] / torch.clamp_min(prev["m"], 1e-37)
    return dict(prev, w_sum=torch.where(over, prev["w_sum"] * scale,
                                        prev["w_sum"]),
                m=torch.where(over, bound[None].expand(prev["m"].shape),
                              prev["m"]))


def spatial_pass(r: Receivers, res: dict, h: int, w: int, dy, dx, noise):
    """One biased pass: neighbours at offsets (dy, dx) [R, N], race noise
    [R+1, K, N]."""
    n = h * w
    dev = dy.device
    row = torch.arange(n, device=dev) // w
    colm = torch.arange(n, device=dev) % w
    ny = torch.clamp(row + dy, 0, h - 1)
    nx = torch.clamp(colm + dx, 0, w - 1)
    q = ny * w + nx  # [R, N]
    nbrs = [{f: a[..., q[j]] for f, a in res.items()}
            for j in range(q.shape[0])]
    depth_ok = (1.0 - r.depth[q] / torch.clamp_min(r.depth, 1e-20)).abs() \
        <= DEPTH_FRAC
    nrm = r.normal[:, q].movedim(0, 1)  # [R, 3, N]
    normal_ok = _dot(nrm, r.normal) >= NORMAL_COS
    gate = r.valid[q] & r.valid & depth_ok & normal_ok
    masks = torch.cat([gate, torch.ones((1, n), dtype=torch.bool,
                                        device=dev)])
    return combine(r, nbrs + [res], masks, noise)


def final_shade(r: Receivers, soup: Soup, res: dict, features: dict):
    k = res["m"].shape[0]
    color = torch.zeros_like(r.pos)
    for lane in range(k):
        sp = res["pos"][lane]
        to = sp - r.pos
        dist = _norm(to)
        d = to * (1.0 / torch.clamp_min(dist, 1e-20))
        o = r.pos + SHADOW_EPS * d
        t_max = _norm(sp - o)
        vis = ~soup.occluded(o, d, t_max) | (dist <= SHADOW_EPS)
        shade = phong(r, sp, res["col"][lane])
        color = color + torch.where(vis[None], shade, 0.0) \
            * res["big_w"][lane]
    color = color / k
    if features["enable_tone_mapping"]:
        color = 1.0 - torch.exp(-float(features["exposure"]) * color)
        color = torch.pow(torch.clamp_min(color, 0.0),
                          1.0 / float(features["gamma"]))
    return color


# ---------------------------------------------------------------- draws

def _gumbel(u):
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-37)))


class CardDraws:
    """The program's draws on the card, in its order: the RIS kernel's key
    (one int64 from the generator, read back), the temporal race's noise
    (uniforms from the generator), the pass kernels' key (one int64 from
    the generator); the kernels' numbers from their Philox streams."""

    def __init__(self, seed: int, dev):
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.dev = dev

    def frame(self, f: dict, h: int, w: int):
        g, dev, n = self.gen, self.dev, h * w
        k = f["num_samples_in_reservoir"]
        ris_key = int(torch.randint(0, 2 ** 62, (), generator=g, device=dev))

        def slot(t):
            return philox.ris_slot(ris_key, t, k, n, dev)

        temporal = _gumbel(torch.rand((2, k, h, w), generator=g, device=dev)
                           ).reshape(2, k, n)
        pass_key = int(torch.randint(0, 2 ** 62, (1,), generator=g,
                                     dtype=torch.int64, device=dev)[0])
        passes = [philox.spatial_pass(
            pass_key, p, f["num_neighbours_to_sample"], k,
            f["spatial_resample_radius"], n, dev)
            for p in range(f["spatial_resampling_passes"])]
        return slot, temporal, passes


class HostDraws:
    """The program's draws on the CPU, where its plain versions draw every
    number from the generator: the RIS uniforms, the temporal race's
    noise, then per pass the offsets and the race noise."""

    def __init__(self, seed: int, dev):
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.dev = dev

    def frame(self, f: dict, h: int, w: int):
        g, dev, n = self.gen, self.dev, h * w
        k, s = f["num_samples_in_reservoir"], f["initial_light_samples"]
        r, rad = f["num_neighbours_to_sample"], f["spatial_resample_radius"]
        u = torch.rand((-(-s // k), 4, k, h, w), generator=g,
                       device=dev).reshape(-1, 4, k, n)

        def slot(t):
            return tuple(u[t, c] for c in range(4))

        temporal = _gumbel(torch.rand((2, k, h, w), generator=g, device=dev)
                           ).reshape(2, k, n)
        passes = []
        for _ in range(f["spatial_resampling_passes"]):
            offs = torch.randint(-rad, rad + 1, (2, r, h, w), generator=g,
                                 dtype=torch.int32, device=dev)
            noise = _gumbel(torch.rand((r + 1, k, h, w), generator=g,
                                       device=dev))
            passes.append((offs[0].reshape(r, n).long(),
                           offs[1].reshape(r, n).long(),
                           noise.reshape(r + 1, k, n)))
        return slot, temporal, passes


# ---------------------------------------------------------------- frames

@torch.no_grad()
def expected(config: dict, traffic: dict, seed: int, device, n: int,
             size=None, control: bool = False) -> list:
    """The cell's first ``n`` frames → [H, W, 3] float32 images on the
    CPU. With ``control`` every float32 result of the frame's arithmetic
    is rounded to bfloat16 (the draws are not)."""
    f = settings(config, traffic)
    d = load(config, size)
    dev = torch.device(device)
    h, w = d.height, d.width
    draws = (CardDraws if dev.type == "cuda" else HostDraws)(seed, dev)
    with lower_precision(control):
        soup, lights = Soup(d, dev), Lights(d, dev)
        r = Receivers(soup, *primary_rays(d, dev))
    k, s = f["num_samples_in_reservoir"], f["initial_light_samples"]
    prev, out = None, []
    for _ in range(n):
        slot, temporal, passes = draws.frame(f, h, w)
        with lower_precision(control):
            res = ris(r, lights, s, k, slot)
            if f["temporal_reuse"]:
                if prev is None:
                    masks = torch.tensor([[True], [False]], device=dev) \
                        .expand(2, h * w)
                    last = res
                else:
                    masks = torch.ones((2, h * w), dtype=torch.bool,
                                       device=dev)
                    last = clamp_history(prev, res,
                                         float(f["temporal_clamp_m"]))
                res = combine(r, [res, last], masks, temporal)
            if f["spatial_reuse"]:
                for dy, dx, noise in passes:
                    res = spatial_pass(r, res, h, w, dy, dx, noise)
            color = final_shade(r, soup, res, f)
        prev = res
        out.append(color.reshape(3, h, w).permute(1, 2, 0).float().cpu())
    return out


def numbers(got: list, want: list) -> dict:
    """The numbers ``correct`` is decided by, worst checked frame:

    - ``mismatch``: the share of pixel channels off the reference's by
      more than 1e-3 of its value plus 1e-3 of the frame's mean (or not
      finite);
    - ``mean_gap``: |mean - the reference's mean| / the reference's mean.
    """
    mismatch, mean_gap = 0.0, 0.0
    for p, q in zip(got, want, strict=True):
        p, q = p.double(), q.double()
        scale = float(q.abs().mean())
        bad = ~torch.isfinite(p) | ((p - q).abs() > 1e-3 * (q.abs() + scale))
        mismatch = max(mismatch, float(bad.double().mean()))
        mq = float(q.mean())
        gap = abs(float(p.mean()) - mq) / max(abs(mq), 1e-30)
        mean_gap = max(mean_gap, gap if math.isfinite(gap) else math.inf)
    return {"mismatch": mismatch, "mean_gap": mean_gap}


def context(config: dict, traffic: dict, device, size=None) -> dict:
    """What the per-layer readers take beside the trace: the cell's
    sizes."""
    f = settings(config, traffic)
    d = load(config, size)
    return {"pixels": d.height * d.width,
            "candidates": f["initial_light_samples"],
            "lanes": f["num_samples_in_reservoir"],
            "triangles": int(d.tris.shape[0])}
