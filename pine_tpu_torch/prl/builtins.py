"""PRL builtin registry.  Counterpart of pine_tpu/prl/builtins.py (parity:
src/pine/core/program_context.cpp:23-125 and the per-module *_context
registrations; names per SURVEY.md Appendix A).

Each name maps to one Python callable that dispatches on argument types and
arity.  Every name pine_tpu registers is registered here.  Those whose
target the port has run it: the Scene and its ``add``/``set``, the analytic
shapes, constant materials, point lights, ThinLenCamera, Film and its tone
mappers, the uniform and blue-noise samplers, the math, vector, matrix and
transform builtins, ``PathIntegrator`` and ``render``, ``save`` and
``println``.  The others raise NotImplementedError naming their ROADMAP.md
modules item when called, so a script that declares something it never uses
still runs (bench.py's box declares a Subsurface material it never applies).
``render`` renders on the device the interpreter was given.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.prl.values import PrlMat, PrlVec, make_vec, prl_to_string, to_float_vec

Pi = float(np.pi)

# builtin -> the ROADMAP.md modules item that ports its target
UNPORTED = {
    # texture nodes and noise, environment lights, image inputs
    **dict.fromkeys(("Position", "Normal", "UV", "Checkerboard", "Noisef", "Noise3f", "Texture",
                     "Function", "Vec3", "Comp", "pnoise", "pnoise2d", "pnoise3d", "fbm",
                     "fbm2d", "fbm3d", "Sky", "Atmosphere", "ImageSky", "load_image"), 10),
    # shapes and lights of the scene model still to port
    **dict.fromkeys(("Line", "SpotLight", "DirectionalLight", "get_aabb"), 3),
    "SDF": 9,
    # meshes from files, the cached path integrator
    **dict.fromkeys(("Mesh", "load", "CachedPathIntegrator"), 7),
    **dict.fromkeys(("HgPF", "Hg2PF", "CloudPF", "HomoMedium", "VDBMedium"), 11),
    **dict.fromkeys(("HaltonSampler", "SobolSampler"), 2),
    **dict.fromkeys(("AOIntegrator", "VolIntegrator", "RandomWalkIntegrator",
                     "GuidedPathIntegrator", "MltIntegrator", "RestirIntegrator",
                     "MicroRenderGI", "denoise"), 12),
    # script lambdas evaluated over a batch of lanes (pine_tpu: under a jax trace)
    **dict.fromkeys(("draw", "heightmap"), 15),
}


def _data(x):
    return x.data if isinstance(x, (PrlVec, PrlMat)) else x


def _isvec(x):
    return isinstance(x, PrlVec)


def _f32(x):
    return np.asarray(_data(to_float_vec(x)), np.float32)


def _unported(name, item):
    def fn(*args):
        _refuse(f"`{name}`", item)

    return fn


class Array2dValue:
    """PRL Array2d* value: a numpy (H,W,C) or (H,W) array."""

    def __init__(self, data):
        self.data = data

    def size(self):
        h, w = self.data.shape[:2]
        return PrlVec(np.asarray([w, h], np.int32), True)

    def get(self, p):
        x, y = int(p.data[0]), int(p.data[1])
        v = self.data[y, x]
        if np.ndim(v) == 0:
            return float(v)
        return PrlVec(np.asarray(v, np.float32))

    def set(self, p, v):
        x, y = int(p.data[0]), int(p.data[1])
        self.data[y, x] = _data(v)


def _vecfn(fn):
    """A batched torch helper of the port's core as a PRL vec -> vec builtin."""

    def f(*args):
        t = [torch.as_tensor(np.asarray(_data(a), np.float32)) for a in args]
        return PrlVec(fn(*t).numpy())

    return f


def make_registry(interp):
    """Build {name: callable}; ``interp`` is the owning Interpreter."""
    from pine_tpu_torch.core import camera as camera_mod
    from pine_tpu_torch.core import samplers as samplers_mod
    from pine_tpu_torch.core import sampling as smp
    from pine_tpu_torch.core import vecmath as vm
    from pine_tpu_torch.core.film import Film
    from pine_tpu_torch.core.rng import RNG
    from pine_tpu_torch.integrators.path import PathIntegrator
    from pine_tpu_torch.io.image_io import save_image
    from pine_tpu_torch.scene import lights as L
    from pine_tpu_torch.scene import materials as M
    from pine_tpu_torch.scene import nodes as N
    from pine_tpu_torch.scene import shapes as S
    from pine_tpu_torch.scene.scene import Scene

    reg = {name: _unported(name, item) for name, item in UNPORTED.items()}

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
    def _nodeish(*args):
        return any(isinstance(a, N.Node) for a in args)

    def _reduce(np_fn, py_fn):
        def fn(*args):
            if _nodeish(*args):
                raise TypeError("min/max over nodes is not registered in PRL")
            if len(args) == 1 and _isvec(args[0]):
                return float(np_fn.reduce(args[0].data))
            if all(not _isvec(a) for a in args):
                r = args[0]
                for a in args[1:]:
                    r = py_fn(r, a)
                return r
            vs = [_data(a) for a in args]
            r = vs[0]
            for v in vs[1:]:
                r = np_fn(r, v)
            return PrlVec(r)

        return fn

    reg["min"] = _reduce(np.minimum, min)
    reg["max"] = _reduce(np.maximum, max)

    @register("abs")
    def _abs(x):
        if _isvec(x):
            return PrlVec(np.abs(x.data), x.is_int)
        return abs(x)

    @register("clamp")
    def _clamp(x, lo, hi):
        if _isvec(x):
            return PrlVec(np.clip(x.data, _data(lo), _data(hi)))
        return float(np.clip(x, _data(lo), _data(hi)))

    @register("lerp")
    def _lerp(t, a, b):
        if _nodeish(t, a, b):
            return _refuse("lerp of texture nodes", 10)
        ad, bd, td = _data(a), _data(b), _data(t)
        r = ad + (bd - ad) * td
        if _isvec(a) or _isvec(b):
            return PrlVec(r)
        return float(r) if np.ndim(r) == 0 else r

    @register("sqr")
    def _sqr(x):
        if isinstance(x, N.Node):
            return _refuse("sqr of a texture node", 10)
        return PrlVec(x.data * x.data, x.is_int) if _isvec(x) else x * x

    def _elementwise(np_fn, name):
        def fn(x):
            if isinstance(x, N.Node):
                return _refuse(f"{name} of a texture node", 10)
            if _isvec(x):
                return PrlVec(np_fn(x.data.astype(np.float32) if x.is_int else x.data))
            return float(np_fn(x))

        return fn

    reg["sqrt"] = _elementwise(np.sqrt, "sqrt")
    reg["fract"] = _elementwise(lambda x: x - np.floor(x), "fract")
    reg["floor"] = _elementwise(np.floor, "floor")
    reg["ceil"] = _elementwise(np.ceil, "ceil")
    for nm, f in (("exp", np.exp), ("log2", np.log2), ("log", np.log), ("log10", np.log10),
                  ("sin", np.sin), ("cos", np.cos), ("tan", np.tan), ("acos", np.arccos),
                  ("asin", np.arcsin), ("sinh", np.sinh), ("cosh", np.cosh),
                  ("tanh", np.tanh)):
        reg[nm] = _elementwise(f, nm)

    reg["powi"] = lambda b, e: int(b**e)

    @register("pow")
    def _pow(b, e):
        if _isvec(b):
            return PrlVec(np.power(b.data.astype(np.float32) if b.is_int else b.data, _data(e)))
        return float(np.power(b, e))

    reg["atan2"] = lambda y, x: float(np.arctan2(y, x))

    @register("normalize")
    def _normalize(v):
        d = v.data
        return PrlVec(d / np.sqrt(np.sum(d * d, -1)))

    @register("length")
    def _length(v, _ignored=None):
        d = _data(v)
        return float(np.sqrt(np.sum(d * d, -1)))

    reg["distance"] = lambda a, b: _length(PrlVec(_data(a) - _data(b)))
    reg["dot"] = lambda a, b: float(np.sum(_data(a) * _data(b), -1))
    reg["cross"] = lambda a, b: PrlVec(np.cross(_data(a), _data(b)))
    reg["sum"] = lambda v: float(np.sum(_data(v), -1))
    reg["max_value"] = lambda v: float(np.max(_data(v), -1))
    reg["min_value"] = lambda v: float(np.min(_data(v), -1))
    reg["max_axis"] = lambda v: int(np.argmax(_data(v)))
    reg["min_axis"] = lambda v: int(np.argmin(_data(v)))

    # ---- vec/mat constructors ----------------------------------------------
    def vec_ctor(n, is_int):
        dt = np.int32 if is_int else np.float32

        def fn(*args):
            if len(args) == 1:
                a = args[0]
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
            return PrlVec(v.data.astype(dt), is_int)

        return fn

    for n in (2, 3, 4):
        reg[f"vec{n}"] = vec_ctor(n, False)
        reg[f"vec{n}i"] = vec_ctor(n, True)

    def mat_ctor(*cols):
        return PrlMat(np.stack([_data(c) for c in cols], -1))

    reg["mat2"] = reg["mat3"] = mat_ctor
    reg["mat4"] = lambda *cols: (
        cols[0] if len(cols) == 1 and isinstance(cols[0], PrlMat) else mat_ctor(*cols))
    reg["identity3x3"] = lambda: PrlMat(np.eye(3, dtype=np.float32))
    reg["identity4x4"] = lambda: PrlMat(np.eye(4, dtype=np.float32))
    reg["transpose"] = lambda m: PrlMat(np.swapaxes(m.data, -1, -2))
    reg["determinant"] = lambda m: float(np.linalg.det(np.asarray(m.data)))
    reg["inverse"] = lambda m: PrlMat(
        np.linalg.inv(np.asarray(m.data, np.float64)).astype(np.float32))
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

    def uniform_sphere(u):
        cos_t = 1.0 - 2.0 * u[..., 1]
        return sph_to_cart(u[..., 0] * Pi * 2, torch.sqrt(torch.clamp_min(1.0 - cos_t**2, 0.0)),
                           cos_t)

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
        lambda d: vm.cartesian_to_spherical(d) / torch.tensor([2 * Pi, Pi]))
    reg["sample_disk_polar"] = _vecfn(smp.sample_disk_polar)
    reg["sample_disk_concentric"] = _vecfn(smp.sample_disk_concentric)
    reg["cosine_weighted_hemisphere"] = _vecfn(smp.cosine_weighted_hemisphere)
    reg["uniform_sphere"] = _vecfn(uniform_sphere)
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

    # ---- materials (material.cpp): constant parameters ----------------------
    def matarg(x):
        if isinstance(x, N.Node):
            return x
        if _isvec(x):
            return N.Constant(_f32(x))
        if isinstance(x, Array2dValue):
            return _refuse("an image as a material parameter", 10)
        return N.Constant(float(x))

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

    # ---- lights (light.cpp:174-186) ----------------------------------------
    reg["PointLight"] = lambda p, c: L.PointLight(_f32(p), _f32(c))

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
    reg["BlueSampler"] = lambda spp: samplers_mod.BlueSampler(int(spp))

    # ---- integrators (program_context.cpp:54-118) --------------------------
    reg["PathIntegrator"] = lambda sampler, max_len: PathIntegrator(sampler, int(max_len))

    @register("render")
    def _render(integrator, scene):
        return integrator.render(scene, device=interp.device)

    # ---- scene (scene.cpp:64-81, program_context.cpp:120-124) --------------
    reg["Scene"] = lambda: Scene()
    reg["add"] = lambda target, *args: target.add(*args)  # Scene.add, Instancing.add
    reg["set"] = lambda scene, x: scene.set(x)

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
        arr = np.asarray(target.data if isinstance(target, Array2dValue) else target)
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

    reg["mse"] = lambda a, b: float(np.mean(
        (np.asarray(a.data, np.float32) - np.asarray(b.data, np.float32)) ** 2))

    @register("rmse")
    def _rmse(ref, b):
        da = np.asarray(ref.data, np.float32)
        db = np.asarray(b.data, np.float32)
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


def _refuse(what, item):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, modules item {item})")
