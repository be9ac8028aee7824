"""PRL builtin registry.  Counterpart of pine_tpu/prl/builtins.py (parity:
src/pine/core/program_context.cpp:23-125 and the per-module *_context
registrations; names per SURVEY.md Appendix A).

Each name maps to one Python callable that dispatches on argument types and
arity.  Every name pine_tpu registers is registered here, and all of them
run: the Scene and its ``add``/``set``/``load``
(GLB files) and ``get_aabb``, the analytic shapes, lines, ``SDF`` (its
distance a script lambda), ``Mesh(file)``, ``heightmap(file)`` and
``heightmap(size, fn)``, the materials, the texture and procedural nodes
(``Function`` of a script lambda among them), the noise functions,
``load_image`` and ``draw``, the lights and environment lights,
ThinLenCamera, Film and its tone mappers, the samplers, the math, vector,
matrix and transform builtins (over traced lanes too), CSG by the operators
+, * and - on shapes, the phase functions and media, every integrator
(path, cached, guided, random-walk, AO, volume, MLT, ReSTIR and
MicroRenderGI), ``denoise``, and ``render``, ``save`` and ``println``.
``render``, ``draw``,
``heightmap(size, fn)`` and ``denoise`` run on the device the interpreter
was given (the card unless it was given the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.prl.values import (
    PrlMat,
    PrlVec,
    as_tensor,
    is_traced,
    lanes_of,
    make_vec,
    prl_to_string,
    scalar_of,
    to_float_vec,
)

Pi = float(np.pi)


def _data(x):
    return x.data if isinstance(x, (PrlVec, PrlMat)) else x


def _isvec(x):
    return isinstance(x, PrlVec)


def _f32(x):
    return np.asarray(_data(to_float_vec(x)), np.float32)


class Array2dValue:
    """PRL Array2d* value: a numpy (H,W,C) or (H,W) array, or the tensor
    ``draw`` leaves on its device until the image is read (``host``)."""

    def __init__(self, data):
        self.data = data

    def host(self):
        if is_traced(self.data):
            self.data = self.data.cpu().numpy()
        return self.data

    def size(self):
        h, w = self.data.shape[:2]
        return PrlVec(np.asarray([w, h], np.int32), True)

    def get(self, p):
        x, y = int(p.data[0]), int(p.data[1])
        v = self.host()[y, x]
        if np.ndim(v) == 0:
            return float(v)
        return PrlVec(np.asarray(v, np.float32))

    def set(self, p, v):
        x, y = int(p.data[0]), int(p.data[1])
        self.host()[y, x] = _data(v)


def _vecfn(fn):
    """A batched torch helper of the port's core as a PRL vec -> vec builtin
    (over traced lanes on their device)."""

    def f(*args):
        like = lanes_of(*args)
        if like is not None:
            return PrlVec(fn(*[as_tensor(_data(a), like, torch.float32) for a in args]))
        t = [torch.as_tensor(np.asarray(_data(a), np.float32)) for a in args]
        return PrlVec(fn(*t).numpy())

    return f


def make_registry(interp):
    """Build {name: callable}; ``interp`` is the owning Interpreter."""
    from pine_tpu_torch.core import camera as camera_mod
    from pine_tpu_torch.core import noise as noise_mod
    from pine_tpu_torch.core import samplers as samplers_mod
    from pine_tpu_torch.core import sampling as smp
    from pine_tpu_torch.core import vecmath as vm
    from pine_tpu_torch.core.film import Film
    from pine_tpu_torch.core.rng import RNG
    from pine_tpu_torch.integrators.path import PathIntegrator
    from pine_tpu_torch.io.image_io import save_image
    from pine_tpu_torch.scene import env_lights as E
    from pine_tpu_torch.scene import lights as L
    from pine_tpu_torch.scene import materials as M
    from pine_tpu_torch.scene import nodes as N
    from pine_tpu_torch.scene import shapes as S
    from pine_tpu_torch.scene.scene import Scene

    reg = {}

    def _device():
        from pine_tpu_torch.core.place import resolve_device

        return resolve_device(interp.device)

    def register(name):
        def deco(fn):
            reg[name] = fn
            return fn

        return deco

    # ---- printing ----------------------------------------------------------
    @register("print")
    def _print(*args):
        interp.out("".join(prl_to_string(a) for a in args))

    reg["println"] = _print

    # ---- constants (registered as plain globals) ---------------------------
    interp.globals.declare("Pi", Pi)
    interp.globals.declare("E", float(np.e))
    interp.globals.declare("X", PrlVec([1.0, 0.0, 0.0]))
    interp.globals.declare("Y", PrlVec([0.0, 1.0, 0.0]))
    interp.globals.declare("Z", PrlVec([0.0, 0.0, 1.0]))

    # ---- scalar & vector math (math.cpp, vecmath.cpp) ----------------------
    # Over traced values (tensors over lanes) the same builtins run in torch on
    # the lanes' device; square roots and transcendental functions go through
    # core/fmath (float64, rounded), so the card and the CPU give the same bits.
    def _nodeish(*args):
        return any(isinstance(a, N.Node) for a in args)

    def _reduce(np_fn, py_fn, t_fn):
        def fn(*args):
            if _nodeish(*args):
                raise TypeError("min/max over nodes is not registered in PRL")
            if len(args) == 1 and _isvec(args[0]):
                d = args[0].data
                if is_traced(d):
                    return (d.amin if np_fn is np.minimum else d.amax)(-1)
                return float(np_fn.reduce(d))
            vs = [_data(a) for a in args]
            if any(is_traced(v) for v in vs):
                like = lanes_of(*vs)
                if any(_isvec(a) for a in args):  # a lane scalar meets vectors
                    vs = [v[..., None] if is_traced(v) and not _isvec(a) else v
                          for a, v in zip(args, vs)]
                r = as_tensor(vs[0], like)
                for v in vs[1:]:
                    r = t_fn(r, as_tensor(v, like))
                return PrlVec(r) if any(_isvec(a) for a in args) else r
            if all(not _isvec(a) for a in args):
                r = args[0]
                for a in args[1:]:
                    r = py_fn(r, a)
                return r
            r = vs[0]
            for v in vs[1:]:
                r = np_fn(r, v)
            return PrlVec(r)

        return fn

    reg["min"] = _reduce(np.minimum, min, torch.minimum)
    reg["max"] = _reduce(np.maximum, max, torch.maximum)

    @register("abs")
    def _abs(x):
        if _isvec(x):
            d = x.data
            return PrlVec(d.abs() if is_traced(d) else np.abs(d), x.is_int)
        return x.abs() if is_traced(x) else abs(x)

    @register("clamp")
    def _clamp(x, lo, hi):
        xd, lo, hi = _data(x), _data(lo), _data(hi)
        if any(is_traced(v) for v in (xd, lo, hi)):
            like = lanes_of(xd, lo, hi)
            r = torch.minimum(torch.maximum(as_tensor(xd, like), as_tensor(scalar_of(lo), like)),
                              as_tensor(scalar_of(hi), like))
            return PrlVec(r) if _isvec(x) else r
        if _isvec(x):
            return PrlVec(np.clip(xd, lo, hi))
        return float(np.clip(xd, lo, hi))

    @register("lerp")
    def _lerp(t, a, b):
        if _nodeish(t, a, b):
            return N.Lerp(matarg(t), matarg(a), matarg(b))
        ad, bd, td = _data(a), _data(b), _data(t)
        if any(is_traced(v) for v in (ad, bd, td)):
            like = lanes_of(ad, bd, td)
            ad, bd, td = (as_tensor(scalar_of(v), like) for v in (ad, bd, td))
            if (_isvec(a) or _isvec(b)) and not _isvec(t) and td.ndim:
                td = td[..., None]  # a lane scalar against vector components
            r = ad + (bd - ad) * td
            return PrlVec(r) if _isvec(a) or _isvec(b) else r
        r = ad + (bd - ad) * td
        if _isvec(a) or _isvec(b):
            return PrlVec(r)
        return float(r) if np.ndim(r) == 0 else r

    @register("sqr")
    def _sqr(x):
        if isinstance(x, N.Node):
            return N.Unary("s", x)
        return PrlVec(x.data * x.data, x.is_int) if _isvec(x) else x * x

    def _elementwise(np_fn, t_fn, node_op=None):
        """An elementwise builtin: ``np_fn`` on concrete values, ``t_fn`` on
        traced ones; of a node, the Unary node ``node_op`` (pine_tpu
        registers sqrt and fract of nodes)."""
        def fn(x):
            if isinstance(x, N.Node):
                if node_op is None:
                    raise TypeError("this function of a texture node is not registered in PRL")
                return N.Unary(node_op, x)
            d = _data(x)
            if is_traced(d):
                r = t_fn(d.to(torch.float32) if not d.dtype.is_floating_point else d)
                return PrlVec(r) if _isvec(x) else r
            if _isvec(x):
                return PrlVec(np_fn(d.astype(np.float32) if x.is_int else d))
            return float(np_fn(x))

        return fn

    reg["sqrt"] = _elementwise(np.sqrt, fm.sqrt, "r")
    reg["fract"] = _elementwise(lambda x: x - np.floor(x), lambda x: x - torch.floor(x), "f")
    reg["floor"] = _elementwise(np.floor, torch.floor)
    reg["ceil"] = _elementwise(np.ceil, torch.ceil)
    for nm, f, tf in (("exp", np.exp, fm.exp), ("log2", np.log2, fm.log2),
                      ("log", np.log, fm.log), ("log10", np.log10, fm.log10),
                      ("sin", np.sin, fm.sin), ("cos", np.cos, fm.cos), ("tan", np.tan, fm.tan),
                      ("acos", np.arccos, fm.acos), ("asin", np.arcsin, fm.asin),
                      ("sinh", np.sinh, fm.sinh), ("cosh", np.cosh, fm.cosh),
                      ("tanh", np.tanh, fm.tanh)):
        reg[nm] = _elementwise(f, tf)

    reg["powi"] = lambda b, e: b**e if is_traced(b) or is_traced(e) else int(b**e)

    @register("pow")
    def _pow(b, e):
        bd, ed = _data(b), _data(e)
        if is_traced(bd) or is_traced(ed):
            like = lanes_of(bd, ed)
            bd = as_tensor(scalar_of(bd), like, torch.float32)
            ed = scalar_of(ed) if not isinstance(ed, np.ndarray) else as_tensor(ed, like)
            if _isvec(b) and not _isvec(e) and is_traced(ed) and ed.ndim:
                ed = ed[..., None]
            r = fm.pow(bd, ed)
            return PrlVec(r) if _isvec(b) else r
        if _isvec(b):
            return PrlVec(np.power(bd.astype(np.float32) if b.is_int else bd, ed))
        return float(np.power(b, e))

    @register("atan2")
    def _atan2(y, x):
        if is_traced(y) or is_traced(x):
            like = lanes_of(y, x)
            return fm.atan2(as_tensor(scalar_of(y), like, torch.float32),
                            as_tensor(scalar_of(x), like, torch.float32))
        return float(np.arctan2(y, x))

    def _sum_last(d):
        """Sum over the last axis, term by term in order (the same bits on
        the card and the CPU)."""
        r = d[..., 0]
        for i in range(1, d.shape[-1]):
            r = r + d[..., i]
        return r

    def _vec_pair(a, b):
        ad, bd = _data(a), _data(b)
        like = lanes_of(ad, bd)
        return as_tensor(ad, like, torch.float32), as_tensor(bd, like, torch.float32)

    @register("normalize")
    def _normalize(v):
        d = v.data
        if is_traced(d):
            d = d.to(torch.float32)
            return PrlVec(d / fm.sqrt(_sum_last(d * d))[..., None])
        return PrlVec(d / np.sqrt(np.sum(d * d, -1)))

    @register("length")
    def _length(v, _ignored=None):
        d = _data(v)
        if is_traced(d):
            d = d.to(torch.float32)
            return fm.sqrt(_sum_last(d * d))
        return float(np.sqrt(np.sum(d * d, -1)))

    @register("distance")
    def _distance(a, b):
        if is_traced(_data(a)) or is_traced(_data(b)):
            ad, bd = _vec_pair(a, b)
            return _length(PrlVec(ad - bd))
        return _length(PrlVec(_data(a) - _data(b)))

    @register("dot")
    def _dot(a, b):
        if is_traced(_data(a)) or is_traced(_data(b)):
            return _sum_last(torch.mul(*_vec_pair(a, b)))
        return float(np.sum(_data(a) * _data(b), -1))

    @register("cross")
    def _cross(a, b):
        if is_traced(_data(a)) or is_traced(_data(b)):
            ad, bd = _vec_pair(a, b)
            ad, bd = torch.broadcast_tensors(ad, bd)
            return PrlVec(torch.stack([ad[..., 1] * bd[..., 2] - ad[..., 2] * bd[..., 1],
                                       ad[..., 2] * bd[..., 0] - ad[..., 0] * bd[..., 2],
                                       ad[..., 0] * bd[..., 1] - ad[..., 1] * bd[..., 0]], -1))
        return PrlVec(np.cross(_data(a), _data(b)))

    def _over_last(np_fn, t_fn, cast):
        def fn(v):
            d = _data(v)
            return t_fn(d) if is_traced(d) else cast(np_fn(d))

        return fn

    reg["sum"] = _over_last(lambda d: np.sum(d, -1), _sum_last, float)
    reg["max_value"] = _over_last(lambda d: np.max(d, -1), lambda d: d.amax(-1), float)
    reg["min_value"] = _over_last(lambda d: np.min(d, -1), lambda d: d.amin(-1), float)
    reg["max_axis"] = _over_last(np.argmax, lambda d: d.argmax(-1).to(torch.int32), int)
    reg["min_axis"] = _over_last(np.argmin, lambda d: d.argmin(-1).to(torch.int32), int)

    # ---- vec/mat constructors ----------------------------------------------
    def vec_ctor(n, is_int):
        dt = np.int32 if is_int else np.float32
        tdt = torch.int32 if is_int else torch.float32

        def fn(*args):
            if len(args) == 1:
                a = args[0]
                d = _data(a)
                if is_traced(d):
                    if _isvec(a):
                        return PrlVec(d[..., :n].to(tdt), is_int)
                    return PrlVec(d.to(tdt)[..., None].expand(*d.shape, n), is_int)
                if _isvec(a):
                    return PrlVec(a.data[..., :n].astype(dt), is_int)
                return PrlVec(np.full(n, a, dt), is_int)
            flat = []
            for c in args:
                if _isvec(c):
                    flat.extend(c.subscript(i) for i in range(c.n))
                else:
                    flat.append(c)
            v = make_vec(flat[:n] if len(flat) >= n else flat)
            if is_traced(v.data):
                return PrlVec(v.data.to(tdt), is_int)
            return PrlVec(v.data.astype(dt), is_int)

        return fn

    for n in (2, 3, 4):
        reg[f"vec{n}"] = vec_ctor(n, False)
        reg[f"vec{n}i"] = vec_ctor(n, True)

    def mat_ctor(*cols):
        ds = [_data(c) for c in cols]
        like = lanes_of(*ds)
        if like is not None:
            ds = [as_tensor(d, like, torch.float32) for d in ds]
            return PrlMat(torch.stack(torch.broadcast_tensors(*ds), -1))
        return PrlMat(np.stack(ds, -1))

    reg["mat2"] = reg["mat3"] = mat_ctor
    reg["mat4"] = lambda *cols: (
        cols[0] if len(cols) == 1 and isinstance(cols[0], PrlMat) else mat_ctor(*cols))
    reg["identity3x3"] = lambda: PrlMat(np.eye(3, dtype=np.float32))
    reg["identity4x4"] = lambda: PrlMat(np.eye(4, dtype=np.float32))
    reg["transpose"] = lambda m: PrlMat(m.data.transpose(-1, -2) if is_traced(m.data)
                                        else np.swapaxes(m.data, -1, -2))
    reg["determinant"] = lambda m: float(np.linalg.det(np.asarray(m.data)))
    reg["inverse"] = lambda m: PrlMat(
        torch.linalg.inv(m.data) if is_traced(m.data)
        else np.linalg.inv(np.asarray(m.data, np.float64)).astype(np.float32))
    reg["solve"] = lambda m, b: PrlVec(
        np.linalg.solve(np.asarray(m.data), np.asarray(_data(b))).astype(np.float32))

    # transform builders (host-side numpy mats)
    reg["rotate_x"] = lambda r: PrlMat(vm.rotate_x(float(r)))
    reg["rotate_y"] = lambda r: PrlMat(vm.rotate_y(float(r)))
    reg["rotate_z"] = lambda r: PrlMat(vm.rotate_z(float(r)))

    @register("rotate")
    def _rotate(v):  # Euler XYZ (vecmath.h rotate(vec3))
        v = np.asarray(_data(v), np.float32)
        return PrlMat(vm.rotate_z(v[2]) @ vm.rotate_y(v[1]) @ vm.rotate_x(v[0]))

    reg["translate"] = lambda *a: PrlMat(
        vm.translate(_data(a[0]) if len(a) == 1 else [a[0], a[1], a[2]]))

    @register("scale")
    def _scale(*a):
        if len(a) == 1 and not _isvec(a[0]):
            return PrlMat(vm.scale([a[0]] * 3))
        return PrlMat(vm.scale(_data(a[0]) if len(a) == 1 else [a[0], a[1], a[2]]))

    reg["look_at"] = reg["lookat"] = lambda f, t: PrlMat(vm.look_at(_data(f), _data(t)))

    @register("coordinate_system")
    def _coord(n):
        nt = torch.as_tensor(np.asarray(_data(n), np.float32))
        t, b = vm.coordinate_system(nt)
        return PrlMat(np.stack([t.numpy(), b.numpy(), nt.numpy()], -1))

    # spherical helpers (vecmath.h:1197-1217, sampling.h)
    def sph_to_cart(phi, sin_t, cos_t):
        return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)

    def unit_square_to_cart(sc):
        theta = sc[..., 1] * Pi
        return sph_to_cart(sc[..., 0] * (2 * Pi), torch.sin(theta), torch.cos(theta))

    @register("spherical_to_cartesian")
    def _s2c(phi, *rest):
        f = lambda x: torch.tensor(float(x))  # noqa: E731
        if len(rest) == 1:
            return PrlVec(sph_to_cart(f(phi), torch.sin(f(rest[0])),
                                      torch.cos(f(rest[0]))).numpy())
        return PrlVec(sph_to_cart(f(phi), f(rest[0]), f(rest[1])).numpy())

    reg["unit_square_to_cartesian"] = _vecfn(unit_square_to_cart)
    reg["cartesian_to_spherical"] = _vecfn(vm.cartesian_to_spherical)
    reg["cartesian_to_unit_square"] = _vecfn(
        lambda d: vm.cartesian_to_spherical(d) / torch.tensor([2 * Pi, Pi], device=d.device))
    reg["sample_disk_polar"] = _vecfn(smp.sample_disk_polar)
    reg["sample_disk_concentric"] = _vecfn(smp.sample_disk_concentric)
    reg["cosine_weighted_hemisphere"] = _vecfn(smp.cosine_weighted_hemisphere)
    reg["uniform_sphere"] = _vecfn(smp.uniform_sphere)
    reg["uniform_hemisphere"] = _vecfn(smp.uniform_hemisphere)
    reg["inverse_uniform_sphere"] = reg["cartesian_to_unit_square"]
    reg["inverse_uniform_hemisphere"] = _vecfn(lambda d: torch.stack(
        [vm.phi2pi(d[..., 0], d[..., 1]) / (2 * Pi), torch.acos(d[..., 2])], -1))

    # ---- RNG (rng.cpp) -----------------------------------------------------
    global_rng = RNG(0)
    reg["RNG"] = lambda *a: RNG(int(a[0]) if a else 0)
    reg["srand"] = lambda s: global_rng.seed(int(s))
    reg["randf"] = lambda *a: float((a[0] if a else global_rng).uniformf())
    reg["rand2f"] = lambda *a: PrlVec((a[0] if a else global_rng).uniform2f())
    reg["rand3f"] = lambda *a: PrlVec((a[0] if a else global_rng).uniform3f())
    reg["nextf"] = lambda rng: float(rng.uniformf())
    reg["next2f"] = lambda rng: PrlVec(rng.uniform2f())
    reg["next3f"] = lambda rng: PrlVec(rng.uniform3f())

    # ---- texture nodes (node.cpp) and materials (material.cpp) -------------
    def matarg(x):
        """A node of a script value: a node, a constant, or an image's texture."""
        if isinstance(x, N.Node):
            return x
        if _isvec(x):
            return N.Constant(_f32(x))
        if isinstance(x, Array2dValue):
            return N.Texture(N.UV(), x.host())
        return N.Constant(float(x))

    reg["UV"] = lambda: N.UV()
    reg["Texture"] = lambda p, image: N.Texture(
        matarg(p), image.host() if isinstance(image, Array2dValue) else image)
    reg["Position"] = lambda: N.Position()
    reg["Normal"] = lambda: N.Normal()
    reg["Checkerboard"] = lambda p=None, ratio=0.5: N.Checkerboard(
        N.UV() if p is None else matarg(p), float(ratio))
    reg["Noisef"] = lambda p, octaves: N.Noisef(matarg(p), matarg(octaves))
    reg["Noise3f"] = lambda p, octaves: N.Noise3f(matarg(p), matarg(octaves))
    reg["Vec3"] = lambda *a: N.ToVec3(*map(matarg, a))
    reg["Comp"] = lambda p, i: N.Component(matarg(p), int(i))
    reg["Function"] = lambda f: N.Function(f.as_node_fn())

    # ---- noise (node.cpp pnoise/fbm) on script values -----------------------
    def noise_call(fn, x, arg):
        d = _data(x)
        if is_traced(d):  # lanes: a scalar (N,) or a vector (N, k)
            r = fn(d.to(torch.float32), scalar_of(arg))
            return r if r.ndim <= 1 else PrlVec(r)
        r = fn(torch.as_tensor(np.asarray(d, np.float32)), arg).numpy()
        return float(r) if r.ndim == 0 else PrlVec(r)

    def pnoise_k(k):
        return lambda x, seed=0: noise_call(
            lambda p, s: torch.stack([noise_mod.perlin_any(p, int(s) + i) for i in range(k)], -1),
            x, seed)

    reg["pnoise"] = lambda x, seed=0: noise_call(lambda p, s: noise_mod.perlin_any(p, int(s)),
                                                 x, seed)
    reg["pnoise2d"] = pnoise_k(2)
    reg["pnoise3d"] = pnoise_k(3)
    reg["fbm"] = lambda x, octaves: (N.Noisef(x, octaves) if _nodeish(x, octaves)
                                     else noise_call(noise_mod.fbm, x, octaves))
    reg["fbm2d"] = lambda x, octaves: noise_call(noise_mod.fbm2d, x, octaves)
    reg["fbm3d"] = lambda x, octaves: (N.Noise3f(x, octaves) if _nodeish(x, octaves)
                                       else noise_call(noise_mod.fbm3d, x, octaves))

    @register("load_image")
    def _load_image(filename):
        from pine_tpu_torch.io.image_io import load_image

        return Array2dValue(load_image(filename))

    reg["Emissive"] = lambda color: M.Emissive(matarg(color))
    reg["Diffuse"] = lambda albedo: M.Diffuse(matarg(albedo))
    reg["Metal"] = lambda albedo, rough: M.Metal(matarg(albedo), matarg(rough))
    reg["Glossy"] = lambda albedo, rough, ior=1.4: M.Glossy(
        matarg(albedo), matarg(rough), matarg(ior))
    reg["Glass"] = lambda albedo, rough, ior=1.4: M.Glass(
        matarg(albedo), matarg(rough), matarg(ior))
    reg["Subsurface"] = lambda albedo, rough, sigma_s: M.Subsurface(
        matarg(albedo), matarg(rough),
        _f32(sigma_s) if _isvec(sigma_s) else np.full(3, float(sigma_s), np.float32))
    reg["Uber"] = lambda albedo, rough, metallic=0.0, transmission=0.0, ior=1.45: M.Uber(
        matarg(albedo), matarg(rough), matarg(metallic), matarg(transmission), float(ior))

    # ---- shapes (geometry.cpp:901-946) -------------------------------------
    reg["Sphere"] = lambda c, r: S.Sphere(_f32(c), float(r))
    reg["Plane"] = lambda p, n: S.Plane(_f32(p), _f32(n))
    reg["Disk"] = lambda p, n, r: S.Disk(_f32(p), _f32(n), float(r))
    reg["Rect"] = lambda p, ex, ey, flip=False: S.Rect(_f32(p), _f32(ex), _f32(ey), bool(flip))
    reg["Cone"] = lambda p, n, r, h: S.Cone(_f32(p), _f32(n), float(r), float(h))
    reg["Cylinder"] = lambda p0, p1, r: S.Cylinder(_f32(p0), _f32(p1), float(r))
    reg["Line"] = lambda p0, p1, t: S.Line(_f32(p0), _f32(p1), float(t))
    reg["Triangle"] = lambda a, b, c: S.Triangle(_f32(a), _f32(b), _f32(c))
    reg["AABB"] = lambda lo, up: S.BoxAABB(_f32(lo), _f32(up))
    reg["OBB"] = lambda aabb, m: S.BoxOBB(aabb, m.data)

    @register("Box")
    def _box(*a):
        if len(a) == 2 and isinstance(a[0], S.BoxAABB):
            return S.BoxOBB(a[0], a[1].data)
        if len(a) == 2:
            return S.BoxAABB(_f32(a[0]), _f32(a[1]))
        return S.BoxOBB(S.BoxAABB(_f32(a[0]), _f32(a[1])), a[2].data)

    reg["Instancing"] = lambda mesh: S.InstancedShape(mesh)  # geometry.cpp:941-946

    @register("Mesh")
    def _mesh(filename):
        from pine_tpu_torch.io.gltf import mesh_from_glb

        return mesh_from_glb(filename)

    @register("SDF")
    def _sdf(*a):
        """SDF(center, half_size, fn) or SDF(aabb, fn): the distance a script
        lambda over the march's lanes (geometry.cpp:730-762)."""
        if len(a) == 3:
            center, half, fn = a
            return S.SDFShape(_f32(center), _f32(half), fn.as_vec3_to_f32())
        aabb, fn = a
        return S.SDFShape((aabb.lower + aabb.upper) / 2, (aabb.upper - aabb.lower) / 2,
                          fn.as_vec3_to_f32())

    @register("heightmap")
    def _heightmap(*a):
        """heightmap(file): the mesh of the image's first channel, x along
        the image's width; heightmap(size, fn): of the script lambda over the
        pixel centres, meshgrid "ij", then (w, h) (geometry.cpp heightmap)."""
        if len(a) == 1 and isinstance(a[0], str):
            from pine_tpu_torch.io.image_io import load_image

            return S.heightmap_from_array(load_image(a[0])[..., 0].T)
        size, fn = a
        w, h = int(size.data[0]), int(size.data[1])
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        X, Yg = np.meshgrid(xs, ys, indexing="ij")
        uv = torch.as_tensor(np.stack([X, Yg], -1).reshape(-1, 2), device=_device())
        vals = _data(fn(PrlVec(uv)))
        vals = as_tensor(scalar_of(vals), uv, torch.float32).expand(uv.shape[0])
        return S.heightmap_from_array(vals.cpu().numpy().reshape(w, h))

    # ---- lights (light.cpp:174-186) ----------------------------------------
    reg["PointLight"] = lambda p, c: L.PointLight(_f32(p), _f32(c))
    reg["SpotLight"] = lambda p, d, c, falloff, cutoff=0.0: L.SpotLight(
        _f32(p), _f32(d), _f32(c), float(falloff), float(cutoff))
    reg["DirectionalLight"] = lambda d, c: L.DirectionalLight(_f32(d), _f32(c))
    reg["Sky"] = lambda c: L.Sky(_f32(c))
    reg["Atmosphere"] = lambda sun_dir, sun_color: E.Atmosphere(_f32(sun_dir), _f32(sun_color))
    reg["ImageSky"] = lambda image, tint=None, elevation=0.0, rotation=0.0: E.ImageSky(
        np.asarray(image.data, np.float32), np.ones(3, np.float32) if tint is None else _f32(tint),
        float(elevation), float(rotation))

    # ---- camera / film (camera.cpp:40-45, film.cpp:97-120) -----------------
    reg["Uncharted2"] = lambda: "uncharted2"
    reg["ACES"] = lambda: "aces"
    reg["Film"] = lambda size, tone_mapper="uncharted2": Film(
        (int(size.data[0]), int(size.data[1])), tone_mapper)

    @register("ThinLenCamera")
    def _camera(film, from_p, to_p, fov, len_radius=0.0, focus_distance=1.0):
        return camera_mod.ThinLenCamera(film, _f32(from_p), _f32(to_p), float(fov),
                                        float(len_radius), float(focus_distance))

    @register("film")
    def _film_of(cam=None):
        """Film of a camera; script idiom: ``scene.camera.film()`` (film.cpp:97-120)."""
        if cam is None:
            raise TypeError("film() takes the camera — write `scene.camera.film()`")
        return cam.film

    # ---- samplers (sampler.cpp:167-200) ------------------------------------
    reg["UniformSampler"] = lambda spp: samplers_mod.UniformSampler(int(spp))
    reg["HaltonSampler"] = lambda spp: samplers_mod.HaltonSampler(int(spp))
    reg["SobolSampler"] = lambda spp: samplers_mod.SobolSampler(int(spp))
    reg["BlueSampler"] = lambda spp: samplers_mod.BlueSampler(int(spp))

    # ---- media (medium.cpp:342-354) ----------------------------------------
    from pine_tpu_torch.scene import media as media_mod

    reg["HgPF"] = lambda g=0.0: media_mod.HgPhaseFunction(float(g))
    reg["Hg2PF"] = lambda g0, g1, w: media_mod.TwoLobeHgPhaseFunction(float(g0), float(g1),
                                                                      float(w))
    reg["CloudPF"] = lambda d=0.5: media_mod.CloudPhaseFunction(float(d))
    reg["HomoMedium"] = lambda shape, pf, sigma_a, sigma_s: media_mod.HomogeneousMedium(
        shape, pf, _f32(sigma_a), _f32(sigma_s))

    @register("VDBMedium")
    def _vdbmedium(filename, transform, pf, sigma_a, sigma_s, *rest):
        # VDBMedium(file, transform, pf, sigma_a, sigma_s[, blackbody_intensity,
        # temperature_scale]) (medium.cpp:152)
        return media_mod.VDBMedium(str(filename), _data(transform), pf, _f32(sigma_a),
                                   _f32(sigma_s), *[float(r) for r in rest])

    # ---- integrators (program_context.cpp:54-118) --------------------------
    reg["PathIntegrator"] = lambda sampler, max_len: PathIntegrator(sampler, int(max_len))

    @register("AOIntegrator")
    def _ao(sampler, radius=None):
        from pine_tpu_torch.integrators.ao import AOIntegrator

        return AOIntegrator(sampler, None if radius is None else float(radius))

    @register("VolIntegrator")
    def _vol(sampler):
        from pine_tpu_torch.integrators.vol import VolIntegrator

        return VolIntegrator(sampler)

    @register("RandomWalkIntegrator")
    def _rw(sampler, max_len):
        from pine_tpu_torch.integrators.randomwalk import RandomWalkIntegrator

        return RandomWalkIntegrator(sampler, int(max_len))

    @register("denoise")
    def _denoise(scene):
        from pine_tpu_torch.integrators.denoiser import denoise_scene

        return denoise_scene(scene, device=interp.device)

    @register("CachedPathIntegrator")
    def _cached(sampler, max_len, resolution=128, starting_depth=1):
        from pine_tpu_torch.integrators.cachedpath import CachedPathIntegrator

        return CachedPathIntegrator(sampler, int(max_len), int(resolution), int(starting_depth))

    @register("GuidedPathIntegrator")
    def _guided(sampler, max_len, *rest):
        # later arguments are taken and ignored, as pine_tpu does
        from pine_tpu_torch.integrators.guidedpath import GuidedPathIntegrator

        return GuidedPathIntegrator(sampler, int(max_len))

    @register("MltIntegrator")
    def _mlt(avg_spp, max_len):
        # MltIntegrator(spp: int, max_path_length) (program_context.cpp:103-106):
        # no sampler argument
        from pine_tpu_torch.integrators.mlt import MltIntegrator

        return MltIntegrator(int(avg_spp), int(max_len))

    @register("RestirIntegrator")
    def _restir(sampler, max_len):
        from pine_tpu_torch.integrators.restir import RestirIntegrator

        return RestirIntegrator(sampler, int(max_len))

    @register("MicroRenderGI")
    def _micro(point_count=2048, *rest):
        # later arguments are taken and ignored, as pine_tpu does
        from pine_tpu_torch.integrators.micro_render import MicroRenderIntegrator

        return MicroRenderIntegrator(int(point_count))

    @register("render")
    def _render(integrator, scene):
        return integrator.render(scene, device=interp.device)

    # ---- scene (scene.cpp:64-81, program_context.cpp:120-124) --------------
    reg["Scene"] = lambda: Scene()
    reg["add"] = lambda target, *args: target.add(*args)  # Scene.add, Instancing.add
    reg["set"] = lambda scene, x: scene.set(x)
    reg["load"] = lambda scene, filename, m=None: scene.load(filename, m)
    reg["get_aabb"] = lambda scene: S.BoxAABB(*scene.get_aabb())

    @register("quick_render")
    def _quick_render(scene, from_p, to_p, filename):
        cam = camera_mod.ThinLenCamera(Film((640, 480)), _f32(from_p), _f32(to_p), 0.5)
        scene.set(cam)
        PathIntegrator(samplers_mod.BlueSampler(4), 4).render(scene, device=interp.device)
        cam.film.save(filename)

    @register("save")
    def _save(target, filename, invert_y=False):
        if isinstance(target, Film):
            target.save(filename)
            return
        arr = np.asarray(target.host() if isinstance(target, Array2dValue) else target)
        save_image(filename, arr, invert_y=bool(invert_y), encode_srgb=True)

    # ---- arrays (array.cpp) ------------------------------------------------
    for nm, ch in (("Array2df", 1), ("Array2d2f", 2), ("Array2d3f", 3), ("Array2d4f", 4),
                   ("Array2d3u8", 3), ("Array2d4u8", 4)):
        def actor(ch=ch):
            def fn(size):
                w, h = int(size.data[0]), int(size.data[1])
                return Array2dValue(np.zeros((h, w) if ch == 1 else (h, w, ch), np.float32))

            return fn

        reg[nm] = actor()

    @register("size")
    def _size(x):
        if isinstance(x, Array2dValue):
            return x.size()
        raise TypeError("size() expects an image/array")

    @register("draw")
    def _draw(size, frag):
        """The (h, w, 3) image of the fragment lambda over the pixel centres
        (u.x along the width), computed on the interpreter's device and left
        there until the image is read."""
        w, h = int(size.data[0]), int(size.data[1])
        X, Yg = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32),
                            indexing="xy")
        coords = (np.stack([X, Yg], -1).reshape(-1, 2) + 0.5) / np.asarray([w, h], np.float32)
        img = frag.as_fragment()(torch.as_tensor(coords, device=_device()))
        return Array2dValue(img.reshape(h, w, 3))

    def _host_f32(x):
        return np.asarray(x.host() if isinstance(x, Array2dValue) else _data(x), np.float32)

    reg["mse"] = lambda a, b: float(np.mean((_host_f32(a) - _host_f32(b)) ** 2))

    @register("rmse")
    def _rmse(ref, b):
        da, db = _host_f32(ref), _host_f32(b)
        return float(np.sqrt(np.mean(((da - db) / np.maximum(np.abs(da), 1e-2)) ** 2)))

    # ---- parallel (parallel.cpp:10-15) -------------------------------------
    @register("parallel_for")
    def _parallel_for(n, f):
        for i in range(int(n)):
            f(i)

    @register("parallel_for2d")
    def _parallel_for2d(size, f):
        w, h = int(size.data[0]), int(size.data[1])
        for y in range(h):
            for x in range(w):
                f(PrlVec(np.asarray([x, y], np.int32), True))

    return reg
