"""Why the reduced cone forest at the floor's front edge agrees with pine_tpu on
fewer pixels than the 97 % gate (tests/test_torch_render.py,
test_front_edge_differences_are_not_the_lattice): grazing rays whose cone
discriminant lies within float32 rounding of zero.

32,768 camera rays of that field (``FRONT_EDGE``, film positions and lens
samples from seed 1) go through the port's forced dense route and through
pine_tpu's ``CompiledScene.intersect`` (its XLA packet walk).  On the lanes
whose closest hit is another geometry in the two packages (31 on an
x86-64 host with fused multiply-adds in XLA; the hit cones are neighbours,
t about 1 % apart), the nearer of the two hits is
a cone that one package hits and the other misses, and:

- its float32 discriminant ``b*b - 4*a*c`` (the port's formula,
  scene/intersect.py) lies within four float32 ulps of ``b*b`` of zero, so
  the sign of a rounding decides the hit; XLA's CPU backend fuses
  multiply-adds where the port rounds each product;
- the cone test evaluated in float64 sides with neither package by more than
  about 2:1 (at most 2.5:1, each side at least a quarter of the lanes).

So neither package is the more accurate there; the port's cone formula is
the reference's and stays as it is (ROADMAP.md, properties of the
reference).
"""
from __future__ import annotations

import numpy as np
import torch
from test_torch_render import FRONT_EDGE

torch.set_num_threads(2)

N_RAYS = 32768
ULPS = 4


def cone_test64(row, o, d, tmin):
    """The cone test of scene/intersect.py in float64 -> t, or None on a miss."""
    r = row.astype(np.float64)
    o, d = o.astype(np.float64) - r[0:3], d.astype(np.float64)
    n, A2, h = r[3:6], r[6], r[10]
    dn, on = d @ n, o @ n
    a = -A2 * dn * dn + d @ d
    b = 2 * (-A2 * on * dn + o @ d)
    c = -A2 * on * on + o @ o
    disc = b * b - 4 * a * c
    if not disc > 0:
        return None
    sq = np.sqrt(disc)
    t0 = (-b - sq) / (2 * a)
    t = t0 + sq / a if t0 < tmin else t0
    height = (o + t * d) @ n
    return t if (height < 0 and height >= -h and t > tmin) else None


def cone_disc32(row, o, d):
    """(b*b - 4*a*c, b*b) in float32, the port's expression order."""
    f = np.float32
    o, d = o.astype(f) - row[0:3], d.astype(f)
    n, A2 = row[3:6], row[6]
    dn = f(d[0] * n[0] + d[1] * n[1] + d[2] * n[2])
    on = f(o[0] * n[0] + o[1] * n[1] + o[2] * n[2])
    dd = f(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    od = f(o[0] * d[0] + o[1] * d[1] + o[2] * d[2])
    oo = f(o[0] * o[0] + o[1] * o[1] + o[2] * o[2])
    a = f(-A2 * dn * dn + dd)
    b = f(f(2) * f(-A2 * on * dn + od))
    c = f(-A2 * on * on + oo)
    return f(b * b - f(4) * a * c), f(b * b)


def test_front_edge_lanes_sit_at_zero_discriminant():
    import jax.numpy as jnp
    from pine_tpu.prl.interp import Interpreter

    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.camera import gen_rays
    from pine_tpu_torch.scene import shapes as S

    src = scenes.cone_forest_prl(*FRONT_EDGE, size=48)
    itp = Interpreter()
    itp.run(src, "<front edge>")
    jcs = itp.get_var("scene").compile()
    scene = scenes.prl_scene(src)
    cs = scene.compile("cpu", small_kernel="dense")
    assert [g["variant"] for g in cs.unified["groups"]] == ["dense"] * 3

    rng = np.random.default_rng(1)
    p_film = torch.from_numpy(rng.uniform(size=(N_RAYS, 2)).astype(np.float32))
    u_lens = torch.from_numpy(rng.uniform(size=(N_RAYS, 2)).astype(np.float32))
    ro, rd = (x.contiguous() for x in gen_rays(scene.camera.params("cpu"), p_film, u_lens))
    tmin, tmax = torch.zeros(N_RAYS), torch.full((N_RAYS,), 1e30)
    t_p, g_p, _, _ = (x.numpy() for x in cs.intersect(ro, rd, tmin, tmax))
    t_j, g_j, _, _ = (np.asarray(x) for x in jcs.intersect(
        *(jnp.asarray(x.numpy()) for x in (ro, rd, tmin, tmax))))

    rows = cs.tables[S.CONE].numpy()
    row_of = {int(g): i for i, g in enumerate(cs.type_global[S.CONE].numpy())}
    ro, rd = ro.numpy(), rd.numpy()
    lanes = np.nonzero(g_p != g_j)[0]
    # 31 lanes on an x86-64 host whose XLA fuses multiply-adds; a host that
    # rounds as the port does leaves fewer, and each must still be such a lane
    assert len(lanes) <= 0.005 * N_RAYS, len(lanes)
    sides = {"port": 0, "pine_tpu": 0}
    for i in lanes:
        # the nearer hit: a cone one package hits and the other misses
        near, who, other = (g_p[i], "port", "pine_tpu") if t_p[i] < t_j[i] else (
            g_j[i], "pine_tpu", "port")
        assert int(near) in row_of, (i, near)
        row = rows[row_of[int(near)]]
        disc, bb = cone_disc32(row, ro[i], rd[i])
        assert abs(disc) <= ULPS * np.finfo(np.float32).eps * bb, (i, disc, bb)
        hit64 = cone_test64(row, ro[i], rd[i], 0.0) is not None
        sides[who if hit64 else other] += 1
    lo, hi = sorted(sides.values())
    print(f"front edge: {len(lanes)} of {N_RAYS} lanes differ; float64 sides {sides}")
    if len(lanes) >= 10:  # too few lanes say nothing of a ratio
        assert hi <= 2.5 * max(lo, 1) and lo >= len(lanes) // 4, sides
