"""Material parameter nodes.  Counterpart of pine_tpu/scene/nodes.py.

A node's ``eval(ctx)`` evaluates it for a wavefront: ``ctx`` is a dict of
per-lane tensors ``p`` (N,3), ``n`` (N,3) and ``uv`` (N,2) at the hits, and
the result is a tensor that broadcasts against them, as pine_tpu's traced
jnp expressions do: a constant stays a (3,) or scalar tensor (the caller
broadcasts it), an image texture becomes a per-lane gather.  Ported:
``Constant``, ``Position``, ``Normal``, ``UV``, ``Texture`` (an image looked
up at fract(p.xy), the glTF importer's base-color textures), ``Binary`` (+ -
* / ^ of two nodes, which node arithmetic and the glTF importer's ``Texture *
factor`` build), ``Unary`` (negation, square, square root, fract),
``Lerp``, ``Checkerboard``, the fbm noises ``Noisef`` and ``Noise3f``
(core/noise.py), ``Component``, ``ToVec3`` and ``Function``, a callable of
the ctx (PRL ``Function`` of a script lambda, run over the hits' lanes on
their device; ``as_node`` makes one of any callable).
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import noise as noise_mod


def _on(cache, array, device):
    """``array`` (numpy float32) as a tensor on ``device``, uploaded once."""
    key = str(device)
    if key not in cache:
        cache[key] = torch.as_tensor(array, device=device)
    return cache[key]


class Node:
    """Base of material parameter nodes."""

    def eval(self, ctx):
        raise NotImplementedError

    # node arithmetic, as pine_tpu's nodes overload it (node.cpp registrations)
    def __add__(self, o):
        return Binary("+", self, o)

    def __radd__(self, o):
        return Binary("+", o, self)

    def __sub__(self, o):
        return Binary("-", self, o)

    def __rsub__(self, o):
        return Binary("-", o, self)

    def __mul__(self, o):
        return Binary("*", self, o)

    def __rmul__(self, o):
        return Binary("*", o, self)

    def __truediv__(self, o):
        return Binary("/", self, o)

    def __rtruediv__(self, o):
        return Binary("/", o, self)

    def __pow__(self, o):
        return Binary("^", self, o)

    def __neg__(self):
        return Unary("-", self)


class Constant(Node):
    def __init__(self, value):
        self.value = np.asarray(value, np.float32)
        self._dev = {}

    def eval(self, ctx):
        return _on(self._dev, self.value, ctx["p"].device)


class Position(Node):
    """The hit point."""

    def eval(self, ctx):
        return ctx["p"]


class Normal(Node):
    """The shading normal at the hit."""

    def eval(self, ctx):
        return ctx["n"]


class UV(Node):
    """The hit's texture coordinates as (u, v, 0)."""

    def eval(self, ctx):
        uv = ctx["uv"]
        return torch.cat([uv, torch.zeros_like(uv[..., :1])], dim=-1)


class Binary(Node):
    OPS = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div, "^": torch.pow}

    def __init__(self, op, a, b):
        if op not in self.OPS:
            raise ValueError(f"unknown node operator {op!r}")
        self.op, self.a, self.b = op, as_node(a), as_node(b)

    def eval(self, ctx):
        return self.OPS[self.op](self.a.eval(ctx), self.b.eval(ctx))


class Unary(Node):
    """One of: "-" negation, "s" square, "r" square root, "f" fract."""

    OPS = {"-": torch.neg, "s": lambda x: x * x, "r": torch.sqrt,
           "f": lambda x: x - torch.floor(x)}

    def __init__(self, op, a):
        if op not in self.OPS:
            raise ValueError(f"unknown node operator {op!r}")
        self.op, self.a = op, as_node(a)

    def eval(self, ctx):
        return self.OPS[self.op](self.a.eval(ctx))


class Lerp(Node):
    """lerp(t, a, b) = a + (b - a) * t; a per-lane scalar t blending two
    colors is lifted to (N, 3), as pine_tpu's."""

    def __init__(self, t, a, b):
        self.t, self.a, self.b = as_node(t), as_node(a), as_node(b)

    def eval(self, ctx):
        t = self.t.eval(ctx).to(torch.float32)
        a = self.a.eval(ctx).to(torch.float32)
        b = self.b.eval(ctx).to(torch.float32)
        if t.ndim == 1 and a.ndim == 1 and a.shape[0] == 3 and t.shape[0] != 3:
            a, b, t = a[None, :], b[None, :], t[:, None]
        elif t.ndim > 0 and a.ndim > t.ndim:
            t = t[..., None]
        return a + (b - a) * t


class Checkerboard(Node):
    """1 where the product of the components of fract(p) - ratio is positive,
    else 0 (node.cpp:15-18); ``p`` is UV() by default."""

    def __init__(self, p=None, ratio=0.5):
        self.p = as_node(p) if p is not None else UV()
        self.ratio = float(ratio)

    def eval(self, ctx):
        p = self.p.eval(ctx)
        x = (p - torch.floor(p)) - self.ratio
        return (x[..., 0] * x[..., 1] * x[..., 2] > 0.0).to(torch.float32)


class Noisef(Node):
    """fbm of ``p`` over ``octaves`` octaves (a scalar)."""

    def __init__(self, p, octaves):
        self.p, self.octaves = as_node(p), as_node(octaves)

    def eval(self, ctx):
        return noise_mod.fbm(self.p.eval(ctx), self.octaves.eval(ctx))


class Noise3f(Node):
    """Three fbm of ``p`` with seeds 0, 1 and 2 (a color)."""

    def __init__(self, p, octaves):
        self.p, self.octaves = as_node(p), as_node(octaves)

    def eval(self, ctx):
        return noise_mod.fbm3d(self.p.eval(ctx), self.octaves.eval(ctx))


class Component(Node):
    """Component ``index`` of a vector node."""

    def __init__(self, p, index):
        self.p, self.index = as_node(p), int(index)

    def eval(self, ctx):
        return self.p.eval(ctx)[..., self.index]


class ToVec3(Node):
    """A vector of three scalar nodes, or of one repeated."""

    def __init__(self, *args):
        self.args = [as_node(a) for a in args]

    def eval(self, ctx):
        vals = [a.eval(ctx) for a in self.args]
        if len(vals) == 1:
            vals = vals * 3
        return torch.stack(torch.broadcast_tensors(*vals), -1)


class Texture(Node):
    """Image lookup at fract(p.xy) of the node ``p`` (UV() by default): the
    texel (int(u * w), int(v * h)), each clamped to the image (node.cpp
    NodeImage).  ``image`` is (H,W,C) float32, row y = int(v * h)."""

    def __init__(self, p, image):
        self.p = as_node(p) if p is not None else UV()
        self.image = np.asarray(image, np.float32)
        self._dev = {}

    def eval(self, ctx):
        img = _on(self._dev, self.image, ctx["p"].device)
        p = self.p.eval(ctx)
        uv = p[..., :2] - torch.floor(p[..., :2])
        h, w = self.image.shape[:2]
        # float -> int32 truncates, as jnp's astype does; the low clamp only
        # guards the gather against the non-finite uv of lanes that hit nothing
        x = (uv[..., 0] * w).to(torch.int32).clamp(0, w - 1)
        y = (uv[..., 1] * h).to(torch.int32).clamp(0, h - 1)
        return img[y.long(), x.long()]


class Function(Node):
    """A callable f(ctx) -> value over the ctx's lanes (node.h NodeFunction;
    in the reference a JIT-compiled PRL closure, here a script lambda's
    bridge, interp.PrlLambda.as_node_fn)."""

    def __init__(self, fn):
        self.fn = fn

    def eval(self, ctx):
        v = self.fn(ctx)
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v, np.float32), device=ctx["p"].device)


def as_node(x):
    if isinstance(x, Node):
        return x
    if callable(x):
        return Function(x)
    return Constant(x)


def constant_value(node):
    """The value of a constant node, or the array a value node was made of."""
    if isinstance(node, Constant):
        return node.value
    return np.asarray(node, np.float32)


def eval_scalar_node(node, ctx, n_lanes):
    """A float node's value for each of ``n_lanes`` lanes -> (N,)."""
    v = as_node(node).eval(ctx).to(torch.float32)
    if v.ndim == 0:
        return v.expand(n_lanes)
    return v.reshape(n_lanes)


def eval_vec3_node(node, ctx, n_lanes):
    """A color node's value for each of ``n_lanes`` lanes -> (N,3)."""
    v = as_node(node).eval(ctx).to(torch.float32)
    if v.ndim == 0 or tuple(v.shape) == (3,):
        return v.expand(n_lanes, 3)
    if v.ndim == 1:
        return v[:, None].expand(n_lanes, 3)
    return v.reshape(n_lanes, 3)
