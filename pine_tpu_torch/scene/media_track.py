"""Delta and ratio tracking through grid media, as bounded wavefront loops.
Counterpart of pine_tpu/scene/media_track.py (parity: medium.cpp:204-290).

The reference's unbounded rejection loops are loops of TRACK_STEPS steps
with per-lane masks: a lane whose walk has not ended within them passes
through (no scatter, its transmittance so far).  Randomness is counter
based: step i of a lane draws ``rng.uniform(key, i, salt)``, pine_tpu's bits.

Only the lanes that still walk are stepped: the loops start on the lanes
whose segment meets the grid's box, and every EXIT_CHECK steps they drop
the lanes whose walk has ended (a gather of the lanes' state, after their
outputs are written back), and end once none walks.  That is exact: a step
changes a lane only while it walks, every operation is per lane, and each
step's draw depends on its own counter, not on the steps before it
(tests/test_torch_media.py holds the outputs to those of all TRACK_STEPS
steps on every lane).  Each check reads the count of walking lanes back
from the device.
"""
from __future__ import annotations

import torch

from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core import rng
from pine_tpu_torch.scene.csg_intersect import on_device

TRACK_STEPS = 96
EXIT_CHECK = 8  # steps between the compactions of the walking lanes


def ray_key(ro, rd):
    """A uint32 key per lane (held in int64) from the rays' bits."""
    rb = ro.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    db = rd.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return rng.hash_combine(rb[:, 0], rb[:, 1], rb[:, 2], db[:, 0], db[:, 1], db[:, 2])


def _u(key, step, salt):
    return rng.uniform(key, step, salt)


def _lanes(mask):
    """The rows of the lanes where ``mask`` holds (reads their count back)."""
    return torch.nonzero(mask)[:, 0]


def grid_transmittance(med, ro, rd, tmax, key):
    """Ratio tracking (medium.cpp:264-290) -> (N,3) transmittance: the
    product of (1 - sigma_t(x_k) / sigma_maj) over majorant-spaced points."""
    n = ro.shape[0]
    t_in, t_out = med.bounds_interval(ro, rd)
    t_hi = torch.minimum(t_out, tmax)
    w_all = torch.ones(n, device=ro.device)
    if med.sigma_maj <= 0.0:
        return w_all[:, None].expand(n, 3).contiguous()
    inv_maj = 1.0 / med.sigma_maj
    idx = _lanes(t_hi > t_in)
    t, o, d, hi, k = t_in[idx], ro[idx], rd[idx], t_hi[idx], key[idx]
    w = torch.ones_like(t)
    alive = torch.ones_like(t, dtype=torch.bool)
    for i in range(TRACK_STEPS):
        if idx.numel() == 0:
            break
        t2 = t - fm.log(torch.clamp_min(1.0 - _u(k, i, 911), 1e-7)) * inv_maj
        out = t2 >= hi
        p = o + t2[:, None] * d
        dd = torch.clamp_min(1.0 - med.sigma_z_bar * med.density_at(p) * inv_maj, 0.0)
        act = alive & ~out
        w = torch.where(act, w * dd, w)
        alive = act & (w > 1e-5)  # dead once opaque
        t = torch.where(act, t2, t)
        if (i + 1) % EXIT_CHECK == 0:
            w_all[idx] = w
            keep = _lanes(alive)
            idx, t, o, d, hi, k, w, alive = (x[keep] for x in (idx, t, o, d, hi, k, w, alive))
    w_all[idx] = w
    return w_all[:, None].expand(n, 3).contiguous()


def grid_sample_scatter(med, ro, rd, t_limit, key):
    """Null-collision delta tracking (medium.cpp:204-251) -> (scattered,
    t_scatter, weight (N,3), absorbed, le_emitted (N,3)).  A lane that
    passes through carries its transmittance stochastically; the weight is
    the chromatic sigma_s over its mean; an emissive medium adds, at every
    collision, the blackbody radiance weighted by the absorption
    probability (pine_tpu's expected-value form of the emit-on-absorb
    branch)."""
    n, dv = ro.shape[0], ro.device
    t_in, t_out = med.bounds_interval(ro, rd)
    t_hi = torch.minimum(t_out, t_limit)
    out_sc = torch.zeros(n, dtype=torch.bool, device=dv)
    out_abs = torch.zeros_like(out_sc)
    out_ts = torch.zeros(n, device=dv)
    out_le = torch.zeros(n, 3, device=dv)
    if med.sigma_maj <= 0.0:
        return out_sc, out_ts, torch.ones(n, 3, device=dv), out_abs, out_le
    inv_maj = 1.0 / med.sigma_maj
    if med.emissive:
        ratio_a = on_device(med, "sigma_a", ro) / max(med.sigma_a_bar, 1e-8)
    idx = _lanes(t_hi > t_in)
    t, o, d, hi, k = t_in[idx], ro[idx], rd[idx], t_hi[idx], key[idx]
    walking = torch.ones_like(t, dtype=torch.bool)
    scattered, absorbed = torch.zeros_like(walking), torch.zeros_like(walking)
    t_scat, le_acc = torch.zeros_like(t), torch.zeros_like(o)
    u_chain = _u(k, 0, 881)
    for i in range(TRACK_STEPS):
        if idx.numel() == 0:
            break
        t2 = t - fm.log(torch.clamp_min(1.0 - _u(k, i, 523), 1e-7)) * inv_maj
        out = t2 >= hi
        p = o + t2[:, None] * d
        D = med.density_at(p)
        sig_t = med.sigma_z_bar * D
        sig_s = med.sigma_s_bar * D
        prob_n = torch.clamp_min(1.0 - sig_t * inv_maj, 0.0)
        prob_s = sig_s * inv_maj
        is_null = u_chain < prob_n
        is_scat = ~is_null & (u_chain < prob_n + prob_s)
        is_abs = ~is_null & ~is_scat
        u_chain = torch.where(is_null, u_chain / torch.clamp_min(prob_n, 1e-7), u_chain)
        act = walking & ~out
        if med.emissive:
            prob_a = torch.clamp_min((sig_t - sig_s) * inv_maj, 0.0)
            le_acc = le_acc + torch.where(act[:, None],
                                          (prob_a[:, None] * med.emission_at(p)) * ratio_a, 0.0)
        scattered = scattered | (act & is_scat)
        absorbed = absorbed | (act & is_abs)
        t_scat = torch.where(act & is_scat, t2, t_scat)
        walking = act & is_null
        t = torch.where(act, t2, t)
        if (i + 1) % EXIT_CHECK == 0:
            out_sc[idx], out_abs[idx], out_ts[idx], out_le[idx] = scattered, absorbed, t_scat, le_acc
            keep = _lanes(walking)
            idx, t, o, d, hi, k, walking, scattered, absorbed, t_scat, le_acc, u_chain = (
                x[keep] for x in (idx, t, o, d, hi, k, walking, scattered, absorbed, t_scat,
                                  le_acc, u_chain))
    out_sc[idx], out_abs[idx], out_ts[idx], out_le[idx] = scattered, absorbed, t_scat, le_acc
    w = on_device(med, "sigma_s", ro) / max(med.sigma_s_bar, 1e-8)
    return out_sc, out_ts, w[None, :].expand(n, 3).contiguous(), out_abs, out_le
