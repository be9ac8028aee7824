"""PRL builtin registry.  Counterpart of pine_tpu/prl/builtins.py (parity:
src/pine/core/program_context.cpp:23-125 and the per-module *_context
registrations; names per SURVEY.md Appendix A).

Each name maps to one Python callable that dispatches on argument types and
arity.  Every name pine_tpu registers is registered here.  Those whose
target the port has run it: the Scene and its ``add``/``set``/``load``
(GLB files) and ``get_aabb``, the analytic shapes, lines, ``Mesh(file)``
and ``heightmap(file)``, the materials, the texture and procedural nodes
(``UV``, ``Texture``, ``Position``, ``Normal``, ``Checkerboard``,
``Noisef``, ``Noise3f``, ``Vec3``, ``Comp`` and ``lerp``, ``sqr``,
``sqrt``, ``fract`` of nodes), the noise functions and ``load_image``,
point, spot and directional lights, the environment lights (``Sky``,
``Atmosphere``, ``ImageSky``), ThinLenCamera, Film and its tone mappers,
the uniform, Halton, Sobol and blue-noise samplers, the math, vector,
matrix and transform builtins, CSG by the operators +, * and - on shapes,
the phase functions (``HgPF``, ``Hg2PF``, ``CloudPF``) and media
(``HomoMedium``, ``VDBMedium``), ``PathIntegrator``,
``CachedPathIntegrator``, ``AOIntegrator``, ``VolIntegrator`` and
``render``, ``save`` and ``println``.  The
others raise NotImplementedError naming their ROADMAP.md modules item when
called.  ``render`` renders on the device the interpreter was given.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.prl.values import PrlMat, PrlVec, make_vec, prl_to_string, to_float_vec

Pi = float(np.pi)

# builtin -> the ROADMAP.md modules item that ports its target
UNPORTED = {
    **dict.fromkeys(("RandomWalkIntegrator", "GuidedPathIntegrator", "MltIntegrator",
                     "RestirIntegrator", "MicroRenderGI", "denoise"), 12),
    # script lambdas evaluated over a batch of lanes (pine_tpu: under a jax trace);
    # heightmap(size, fn) too (``heightmap(file)`` is ported), and SDF, whose
    # distance is a script lambda (the Python API's SDFShape takes a torch function)
    **dict.fromkeys(("draw", "Function", "SDF"), 15),
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
            return N.Lerp(matarg(t), matarg(a), matarg(b))
        ad, bd, td = _data(a), _data(b), _data(t)
        r = ad + (bd - ad) * td
        if _isvec(a) or _isvec(b):
            return PrlVec(r)
        return float(r) if np.ndim(r) == 0 else r

    @register("sqr")
    def _sqr(x):
        if isinstance(x, N.Node):
            return N.Unary("s", x)
        return PrlVec(x.data * x.data, x.is_int) if _isvec(x) else x * x

    def _elementwise(np_fn, node_op=None):
        """An elementwise builtin; of a node, the Unary node ``node_op``
        (pine_tpu registers sqrt and fract of nodes)."""
        def fn(x):
            if isinstance(x, N.Node):
                if node_op is None:
                    raise TypeError("this function of a texture node is not registered in PRL")
                return N.Unary(node_op, x)
            if _isvec(x):
                return PrlVec(np_fn(x.data.astype(np.float32) if x.is_int else x.data))
            return float(np_fn(x))

        return fn

    reg["sqrt"] = _elementwise(np.sqrt, "r")
    reg["fract"] = _elementwise(lambda x: x - np.floor(x), "f")
    reg["floor"] = _elementwise(np.floor)
    reg["ceil"] = _elementwise(np.ceil)
    for nm, f in (("exp", np.exp), ("log2", np.log2), ("log", np.log), ("log10", np.log10),
                  ("sin", np.sin), ("cos", np.cos), ("tan", np.tan), ("acos", np.arccos),
                  ("asin", np.arcsin), ("sinh", np.sinh), ("cosh", np.cosh),
                  ("tanh", np.tanh)):
        reg[nm] = _elementwise(f)

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
            return N.Texture(N.UV(), x.data)
        return N.Constant(float(x))

    reg["UV"] = lambda: N.UV()
    reg["Texture"] = lambda p, image: N.Texture(
        matarg(p), image.data if isinstance(image, Array2dValue) else image)
    reg["Position"] = lambda: N.Position()
    reg["Normal"] = lambda: N.Normal()
    reg["Checkerboard"] = lambda p=None, ratio=0.5: N.Checkerboard(
        N.UV() if p is None else matarg(p), float(ratio))
    reg["Noisef"] = lambda p, octaves: N.Noisef(matarg(p), matarg(octaves))
    reg["Noise3f"] = lambda p, octaves: N.Noise3f(matarg(p), matarg(octaves))
    reg["Vec3"] = lambda *a: N.ToVec3(*map(matarg, a))
    reg["Comp"] = lambda p, i: N.Component(matarg(p), int(i))

    # ---- noise (node.cpp pnoise/fbm) on script values -----------------------
    def noise_call(fn, x, arg):
        r = fn(torch.as_tensor(np.asarray(_data(x), np.float32)), arg).numpy()
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

    @register("heightmap")
    def _heightmap(*a):
        """heightmap(file): the mesh of the image's first channel, x along
        the image's width (geometry.cpp heightmap)."""
        if len(a) != 1 or not isinstance(a[0], str):
            _refuse("`heightmap(size, function)`", 15)
        from pine_tpu_torch.io.image_io import load_image

        return S.heightmap_from_array(load_image(a[0])[..., 0].T)

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

    @register("CachedPathIntegrator")
    def _cached(sampler, max_len, resolution=128, starting_depth=1):
        from pine_tpu_torch.integrators.cachedpath import CachedPathIntegrator

        return CachedPathIntegrator(sampler, int(max_len), int(resolution), int(starting_depth))

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
