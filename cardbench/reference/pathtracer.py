"""The plain reference of a path-traced frame's glue: what the frame
derives from its queries' answers, for a set of paths, in float64 (the
judge) or float16 (the control).

It imports nothing of the program. It follows the published semantics of
``raycore_tpu_torch/render/pathtracer.py`` (``trace_paths_staged``: a
4-bounce wavefront path tracer with next-event estimation toward one
point light drawn per path and bounce, a diffuse or mirror BRDF sample,
and a coherence-sorting compaction every bounce), written out plainly:

    primary     pinhole look-at rays through each pixel at the frame's
                sub-pixel jitter, pixel-major (path id = pixel * spp + s)
    nee         the hit point and the unit normal (both interpolated by
                the answer's barycentrics, the normal turned against the
                ray), the shadow ray toward the drawn light: origin
                p + eps n, direction to the light, t_max its distance
                less 2 eps (-1 where the path missed or is dead)
    shade       the background times the throughput where a live path
                missed; where it hit, the Lambertian next-event term
                base / pi (1 - metallic) intensity max(n.wi, 0) / dist^2
                times the number of lights (one light drawn of n_lights),
                zero where the shadow ray is occluded
    scatter     the mirror direction (reflected about n, jittered by
                0.25 roughness times the drawn normals, renormalized)
                where the BRDF uniform is below metallic, else a cosine
                sample of the hemisphere about n (concentric disk); the
                throughput times the base colour; origin p + eps n; the
                path lives on where it hit
    sort_key    dead paths last, then the direction octant, then the top
                27 bits of the origin's 30-bit Morton code in the scene's
                box (10 bits an axis, x on the top bit of each triad)
    pixel       each pixel's mean over its samples, clamped to [0, 1]

It takes each bounce's inputs from the frame being judged (the rays the
frame submitted to the closest query, its closest-hit answers and its
occlusion answers, per path) and the frame's random draws, which it
draws itself from a ``torch.Generator`` seeded as the frame's, in the
frame's order. The throughput and radiance it carries from bounce to
bounce itself. It works path by path: the compaction order is the sort
of the keys (``compaction_order``), which maps a path to its lane of the
next bounce; the paths are followed by id, so the un-permute is the
identity here.

Departures from the program's text, none of them in the semantics: the
mirror direction is d - 2 (d.n) n (the program reflects -d about n),
norms are square roots of sums of squares, and the Morton code is
interleaved bit by bit.
"""
from __future__ import annotations

import math

import torch


def frame_draws(seed: int, R: int, H: int, W: int, spp: int, n_lights: int,
                bounces: int, device):
    """The frame's draws in its order, in original path order: the
    sub-pixel jitter (R, 2), then per bounce the light index (R,), the
    BRDF uniforms (R, 3) and the roughness normals (R, 3)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    jitter = torch.rand((H, W, spp, 2), generator=gen, device=device)
    out = []
    for _ in range(bounces):
        u_l = torch.randint(0, n_lights, (R,), generator=gen, device=device)
        u_b = torch.rand((R, 3), generator=gen, device=device)
        u_r = torch.randn((R, 3), generator=gen, device=device)
        out.append((u_l, u_b, u_r))
    return jitter.reshape(R, 2), out


def setting(config: dict, dtype, device) -> dict:
    """The configuration's materials, lights, camera and render settings
    as tensors in ``dtype`` (each number first rounded to float32, as the
    program holds it)."""
    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device).to(dtype)
    m, li, c, r = (config["materials"], config["lights"], config["camera"],
                   config["render"])
    return dict(base=t(m["base_color"]), metallic=t(m["metallic"]),
                roughness=t(m["roughness"]), light_pos=t(li["position"]),
                light_int=t(li["intensity"]), cam_pos=t(c["position"]),
                cam_target=t(c["target"]), cam_up=t(c["up"]),
                fov=t(c["fov_deg"]), bg=t(r["background"]),
                eps=float(r["eps"]), W=r["width"], H=r["height"],
                spp=r["spp"], bounces=r["bounces"], dtype=dtype)


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def primary_rays(s: dict, pid, jitter):
    """The camera rays (origin, unit direction) of paths ``pid`` at
    their jitter (S, 2)."""
    dt = s["dtype"]
    fwd = s["cam_target"] - s["cam_pos"]
    fwd = fwd / _norm(fwd)
    right = _cross(fwd, s["cam_up"])
    right = right / _norm(right)
    up = _cross(right, fwd)
    tan_half = torch.tan(s["fov"] * (math.pi / 180.0) * 0.5)
    W, H, spp = s["W"], s["H"], s["spp"]
    pix = pid // spp
    x, y = (pix % W).to(dt), (pix // W).to(dt)
    jit = jitter.to(dt)
    u = ((x + jit[:, 0]) / W * 2.0 - 1.0) * tan_half * (W / H)
    v = (1.0 - (y + jit[:, 1]) / H * 2.0) * tan_half
    d = fwd + u[:, None] * right + v[:, None] * up
    d = d / _norm(d)
    return s["cam_pos"].expand(d.shape), d


def _unit(n):
    length = _norm(n)
    return torch.where(length > 1e-8, n / torch.where(length > 0, length, 1.0),
                       0.0)


def nee(s: dict, d, alive, ans: dict, u_l) -> dict:
    """The surface frame and the shadow ray of paths whose ray direction
    is ``d`` and whose closest-hit answer is ``ans`` (``hit``, ``bary``
    (S, 3), ``verts`` and ``normals`` (S, 3, 3), ``meta``), toward light
    ``u_l``."""
    dt = s["dtype"]
    d = d.to(dt)
    hit = ans["hit"] & alive
    bary = ans["bary"].to(dt)[..., None]
    p = (bary * ans["verts"].to(dt)).sum(-2)
    n = _unit((bary * ans["normals"].to(dt)).sum(-2))
    n = torch.where(_dot(n, d) > 0, -n, n)
    mi = ans["meta"].long().clamp(0, s["base"].shape[0] - 1)
    to_l = s["light_pos"][u_l] - p
    dist = _norm(to_l)[:, 0]
    wi = to_l / torch.clamp(dist[:, None], min=1e-12)
    eps = s["eps"]
    return dict(hit=hit, p=p, n=n, mi=mi, wi=wi, dist=dist, so=p + n * eps,
                st=torch.where(hit, dist - 2 * eps, -1.0))


def shade(s: dict, e: dict, radiance, throughput, alive, res_hit, occluded,
          u_l):
    """The radiance after one bounce's background and next-event terms."""
    radiance = radiance + torch.where((alive & ~res_hit)[:, None],
                                      throughput * s["bg"], 0.0)
    n_lights = s["light_pos"].shape[0]
    metal = s["metallic"][e["mi"]]
    ndotl = torch.clamp(_dot(e["n"], e["wi"])[:, 0], min=0.0)
    f_d = s["base"][e["mi"]] / math.pi * (1.0 - metal)[:, None]
    vis = (~occluded).to(radiance.dtype)
    contrib = f_d * s["light_int"][u_l] * (
        ndotl * vis * n_lights / torch.clamp(e["dist"] ** 2, min=1e-12)
    )[:, None]
    return radiance + torch.where(e["hit"][:, None], throughput * contrib,
                                  0.0)


def _cosine_hemisphere(u):
    """A cosine-weighted direction about +z from uniforms (S, 2): the
    concentric map of the square to the disk, lifted to the sphere."""
    off = 2.0 * u - 1.0
    ox, oy = off[:, 0], off[:, 1]
    degenerate = (ox == 0) & (oy == 0)
    use_x = ox.abs() > oy.abs()
    safe = lambda x: torch.where(x == 0, 1.0, x)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, (oy / safe(ox)) * (math.pi / 4),
                        math.pi / 2 - (ox / safe(oy)) * (math.pi / 4))
    px = torch.where(degenerate, 0.0, r * torch.cos(theta))
    py = torch.where(degenerate, 0.0, r * torch.sin(theta))
    pz = torch.sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))
    return torch.stack([px, py, pz], -1)


def _basis(n):
    """Two tangents completing n to an orthonormal frame (n as +z)."""
    nx, ny, nz = n[:, 0:1], n[:, 1:2], n[:, 2:3]
    sgn = torch.where(nz >= 0, 1.0, -1.0)
    a = -1.0 / (sgn + nz)
    b = nx * ny * a
    t1 = torch.cat([1.0 + sgn * nx * nx * a, sgn * b, -sgn * nx], 1)
    t2 = torch.cat([b, sgn + ny * ny * a, -ny], 1)
    return t1, t2


def scatter(s: dict, e: dict, d, throughput, u_b, u_r):
    """The next bounce's origin, direction, throughput and liveness."""
    dt = s["dtype"]
    d = d.to(dt)
    u_b, u_r = u_b.to(dt), u_r.to(dt)
    n = e["n"]
    metal = s["metallic"][e["mi"]]
    rough = s["roughness"][e["mi"]]
    t1, t2 = _basis(n)
    local = _cosine_hemisphere(u_b[:, 1:3])
    d_diff = t1 * local[:, 0:1] + t2 * local[:, 1:2] + n * local[:, 2:3]
    d_spec = d - 2.0 * _dot(d, n) * n + u_r * rough[:, None] * 0.25
    d_spec = d_spec / torch.clamp(_norm(d_spec), min=1e-12)
    d_next = torch.where((u_b[:, 0] < metal)[:, None], d_spec, d_diff)
    return (e["p"] + n * s["eps"], d_next,
            throughput * s["base"][e["mi"]], e["hit"])


def morton(q):
    """The 30-bit Morton code of integer cells q (S, 3) in [0, 1024): bit
    k of x, y, z at bits 3k + 2, 3k + 1, 3k."""
    code = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for k in range(10):
        for axis, shift in ((0, 2), (1, 1), (2, 0)):
            code |= ((q[:, axis] >> k) & 1) << (3 * k + shift)
    return code


def normalized(o, lo, hi):
    """Origins in the scene's box, clamped to [0, 1] an axis."""
    ext = torch.clamp(hi - lo, min=1e-12)
    return torch.clamp((o - lo) / ext, 0.0, 1.0)


def sort_key(o, d, alive, lo, hi):
    """The compaction key (int64): dead paths last, then the direction
    octant, then the top 27 bits of the origin's Morton code."""
    x = normalized(o, lo.to(o.dtype), hi.to(o.dtype))
    q = torch.clamp(torch.floor(x * 1024.0), 0.0, 1023.0).long()
    octant = ((d[:, 0] > 0).long() | ((d[:, 1] > 0).long() << 1)
              | ((d[:, 2] > 0).long() << 2))
    return ((~alive).long() << 31) | (octant << 28) | (morton(q) >> 3)


def compaction_order(key):
    """The compaction's order: the keys sorted, ties in lane order."""
    return torch.argsort(key, stable=True)


def decode_key(key):
    """(dead (S,), octant bits (S, 3), cell (S, 3) in [0, 512)) of keys."""
    dead = ((key >> 31) & 1).bool()
    octant = torch.stack([(key >> (28 + a)) & 1 for a in range(3)], 1).bool()
    code = key & ((1 << 27) - 1)
    cell = torch.zeros((key.shape[0], 3), dtype=torch.int64,
                       device=key.device)
    for k in range(9):
        for axis, shift in ((0, 2), (1, 1), (2, 0)):
            cell[:, axis] |= ((code >> (3 * k + shift)) & 1) << k
    return dead, octant, cell


def derive(s: dict, data: dict, draws, lo, hi) -> dict:
    """What the frame derives for the paths of ``data``: ``pid`` (S,),
    and per bounce the frame's inputs at each path's lane (``ray_d``,
    ``ray_tmax``, the closest-hit answer ``hit``, ``bary``, ``verts``,
    ``normals``, ``meta``, and the occlusion answer ``occ``); ``draws``
    from ``frame_draws``; ``lo``, ``hi`` (3,) the scene's box, the least
    and greatest vertex coordinates of its triangles. Returns the
    primary rays, per bounce the shadow rays (``so``, ``wi``, ``st``) and,
    but on the last, the next rays (``next_o``, ``next_d``,
    ``next_alive``) with their ``key``, and each sampled path's radiance
    (``radiance``, (S, 3))."""
    dt = s["dtype"]
    pid = data["pid"]
    jitter, bounce_draws = draws
    o0, d0 = primary_rays(s, pid, jitter[pid])
    S = pid.shape[0]
    throughput = torch.ones((S, 3), dtype=dt, device=pid.device)
    radiance = torch.zeros((S, 3), dtype=dt, device=pid.device)
    out = dict(o=o0, d=d0, bounces=[])
    B = s["bounces"]
    for b, inp in enumerate(data["bounces"]):
        u_l, u_b, u_r = (x[pid] for x in bounce_draws[b])
        alive = inp["ray_tmax"] >= 0
        e = nee(s, inp["ray_d"], alive, inp, u_l)
        radiance = shade(s, e, radiance, throughput, alive, inp["hit"],
                         inp["occ"], u_l)
        step = dict(so=e["so"], wi=e["wi"], st=e["st"], hit=e["hit"])
        if b < B - 1:
            o2, d2, throughput, alive2 = scatter(s, e, inp["ray_d"],
                                                 throughput, u_b, u_r)
            step.update(next_o=o2, next_d=d2, next_alive=alive2,
                        key=sort_key(o2, d2, alive2, lo, hi))
        out["bounces"].append(step)
    out["radiance"] = radiance
    return out


def pixels(radiance, spp: int):
    """Each pixel's mean over its spp consecutive samples, clamped to
    [0, 1]."""
    return torch.clamp(radiance.reshape(-1, spp, 3).mean(1), 0.0, 1.0)


def follow(closest, occlusion, keys, pid):
    """The frame's inputs and what it derived, path by path, from its
    recorded queries: ``closest`` and ``occlusion`` hold per bounce the
    (rays, answers) of its queries (rays with ``o``, ``d``, ``t_max``;
    answers with ``hit`` and, for the closest, ``barycentric`` and
    ``triangle`` with ``vertices``, ``normals``, ``metadata``), ``keys``
    its compaction keys per bounce but the last, ``pid`` (S,) the paths.
    A path's lane is its id at bounce 0 and moves by the compaction order
    of the keys. Returns (``data`` for ``derive``, the frame's own
    derivations in ``derive``'s layout but ``radiance``)."""
    lane = pid
    data, got = dict(pid=pid, bounces=[]), dict(bounces=[])
    for b, ((rays, res), (srays, occ)) in enumerate(zip(closest, occlusion)):
        if b == 0:
            got["o"], got["d"] = rays.o[lane], rays.d[lane]
        tri = res.triangle
        data["bounces"].append(dict(
            ray_d=rays.d[lane], ray_tmax=rays.t_max[lane], hit=res.hit[lane],
            bary=res.barycentric[lane], verts=tri.vertices[lane],
            normals=tri.normals[lane], meta=tri.metadata[lane],
            occ=occ.hit[lane]))
        step = dict(so=srays.o[lane], wi=srays.d[lane], st=srays.t_max[lane])
        if b < len(keys):
            order = compaction_order(keys[b])
            inv = torch.empty_like(order)
            inv[order] = torch.arange(order.numel(), device=order.device)
            step["key"] = keys[b][lane]
            lane = inv[lane]
            nxt = closest[b + 1][0]
            step.update(next_o=nxt.o[lane], next_d=nxt.d[lane],
                        next_alive=nxt.t_max[lane] >= 0)
        got["bounces"].append(step)
    return data, got
