"""Material parameter nodes.  Counterpart of pine_tpu/scene/nodes.py.

A node's ``eval(ctx)`` evaluates it for a wavefront: ``ctx`` is a dict of
per-lane tensors ``p`` (N,3), ``n`` (N,3) and ``uv`` (N,2) at the hits, and
the result is a tensor that broadcasts against them, as pine_tpu's traced
jnp expressions do: a constant stays a (3,) or scalar tensor (the caller
broadcasts it), an image texture becomes a per-lane gather.  Ported:
``Constant``, ``UV``, ``Texture`` (an image looked up at fract(p.xy), the
glTF importer's base-color textures) and ``Binary`` (+ - * / ^ of two
nodes, which node arithmetic and the glTF importer's ``Texture * factor``
build).  The procedural nodes (position, normal, noise, checkerboard,
lerp, components, script functions) are not ported yet (ROADMAP.md,
modules item 10): the PRL builtins that make them refuse, and so does
``as_node`` for a script function.
"""
from __future__ import annotations

import numpy as np
import torch


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


class Constant(Node):
    def __init__(self, value):
        self.value = np.asarray(value, np.float32)
        self._dev = {}

    def eval(self, ctx):
        return _on(self._dev, self.value, ctx["p"].device)


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


def as_node(x):
    if isinstance(x, Node):
        return x
    if callable(x):
        raise NotImplementedError(
            "script-function material parameters are not ported yet (ROADMAP.md, modules "
            "item 10)")
    return Constant(x)


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


def constant_vec3(node):
    """An emissive material's constant color as a float32 (3,) array (its
    light is sampled with one color)."""
    node = as_node(node)
    if not isinstance(node, Constant):
        raise NotImplementedError(
            f"a {type(node).__name__} node as an emissive color is not ported yet (ROADMAP.md, "
            "modules item 10)")
    return np.broadcast_to(node.value.reshape(-1), (3,)).astype(np.float32)
