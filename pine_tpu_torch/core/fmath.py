"""Float32 square roots and transcendental functions that give the same bits
on the card and on the CPU.

torch's float32 ``sqrt`` is correctly rounded on the card, as IEEE 754 asks,
but its vectorized CPU form misses the correctly rounded value on about 0.6 %
of inputs; its float32 ``sin``, ``cos``, ``log``, ``exp``, ``atan`` and
``tan`` differ between the two devices on 8-33 % of inputs (each within an
ulp or two).  A path whose random numbers are keyed by a hash of a ray's
bits (the grid media's ratio tracking, scene/media_track.ray_key) turns one
such ulp into another estimate.  So these compute in float64 and round to
float32: the correctly rounded value on both devices, but where the exact
value lies within a float64 ulp or two of a float32 rounding boundary
(about one input in 2^28).  On the card ``sqrt`` is the float32 one, which
is correctly rounded already (so is a float64 square root rounded to
float32: the double rounding is innocuous for sqrt).
"""
from __future__ import annotations

import torch


def sqrt(x):
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).to(x.dtype)


def _rounded(fn):
    def f(x):
        return fn(x.double()).to(x.dtype)

    f.__name__ = fn.__name__
    f.__doc__ = f"torch.{fn.__name__} in float64, rounded to the argument's dtype."
    return f


sin = _rounded(torch.sin)
cos = _rounded(torch.cos)
log = _rounded(torch.log)
exp = _rounded(torch.exp)
atan = _rounded(torch.atan)
tan = _rounded(torch.tan)
tanh = _rounded(torch.tanh)
sinh = _rounded(torch.sinh)
cosh = _rounded(torch.cosh)
acos = _rounded(torch.acos)
asin = _rounded(torch.asin)
log2 = _rounded(torch.log2)
log10 = _rounded(torch.log10)


def pow(x, y):
    """x ** y in float64, rounded to float32 (either may be a Python number)."""
    xd = x.double() if isinstance(x, torch.Tensor) else x
    yd = y.double() if isinstance(y, torch.Tensor) else y
    return torch.pow(xd, yd).to(torch.float32)


def atan2(y, x):
    """atan2 in float64, rounded to float32."""
    return torch.atan2(y.double(), x.double()).to(torch.float32)
