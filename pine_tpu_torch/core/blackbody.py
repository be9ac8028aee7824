"""Blackbody temperature -> RGB.  Counterpart of pine_tpu/core/blackbody.py
(parity: core/blackbody.cpp:12-74).

The colour table (``_RGBS``: 181 temperatures from 1,000 K to 10,000 K) is
computed at import time from Planck's law through CIE XYZ to linear sRGB, in
numpy, by pine_tpu's own code: the port's copy equals pine_tpu's bit for bit
(tests/test_torch_media.py).  ``blackbody_rgb`` looks it up per lane.
"""
from __future__ import annotations

import numpy as np
import torch

_T_MIN, _T_MAX, _N = 1000.0, 10000.0, 181


def _cie_xyz_bar(lam):
    """Analytic multi-lobe Gaussian fit to CIE 1931 (Wyman et al. 2013)."""
    l = lam  # noqa: E741

    def g(x, mu, s1, s2):
        t = (x - mu) * np.where(x < mu, 1.0 / s1, 1.0 / s2)
        return np.exp(-0.5 * t * t)

    x = 1.056 * g(l, 599.8, 37.9, 31.0) + 0.362 * g(l, 442.0, 16.0, 26.7) - 0.065 * g(l, 501.1, 20.4, 26.2)
    y = 0.821 * g(l, 568.8, 46.9, 40.5) + 0.286 * g(l, 530.9, 16.3, 31.1)
    z = 1.217 * g(l, 437.0, 11.8, 36.0) + 0.681 * g(l, 459.0, 26.0, 13.8)
    return x, y, z


def _planck(lam_nm, T):
    """Spectral radiance, unnormalized."""
    lam = lam_nm * 1e-9
    h, c, kb = 6.626e-34, 2.998e8, 1.381e-23
    return (2 * h * c**2) / (lam**5 * (np.exp(h * c / (lam * kb * T)) - 1.0))


def _build_table():
    lams = np.arange(380.0, 781.0, 5.0)
    xb, yb, zb = _cie_xyz_bar(lams)
    Ts = np.linspace(_T_MIN, _T_MAX, _N)
    rgbs = []
    m = np.array(
        [
            [3.2406, -1.5372, -0.4986],
            [-0.9689, 1.8758, 0.0415],
            [0.0557, -0.2040, 1.0570],
        ]
    )
    for T in Ts:
        spec = _planck(lams, T)
        X = (spec * xb).sum()
        Yv = (spec * yb).sum()
        Z = (spec * zb).sum()
        xyz = np.array([X, Yv, Z]) / max(Yv, 1e-30)
        rgb = m @ xyz
        rgb = np.maximum(rgb, 0.0)
        rgbs.append(rgb)
    return Ts.astype(np.float32), np.asarray(rgbs, np.float32)


_TS, _RGBS = _build_table()


def blackbody_rgb(temperature, table=None):
    """Temperatures (K, any shape) -> linear RGB (..., 3) normalized to
    luminance 1, linear between the table's rows; ``table`` is ``_RGBS`` as
    a tensor on the temperatures' device (made here when not given)."""
    if table is None:
        table = torch.as_tensor(_RGBS, device=temperature.device)
    t = torch.clamp(temperature.to(torch.float32), _T_MIN, _T_MAX)
    f = (t - _T_MIN) / (_T_MAX - _T_MIN) * (_N - 1)
    i0 = torch.clamp(f.to(torch.int32), 0, _N - 2).long()
    w = (f - i0)[..., None]
    return table[i0] * (1 - w) + table[i0 + 1] * w
