"""The house path (scenes/house.pine: a GLB with textured Uber materials under a
DirectionalLight, CachedPathIntegrator) through pine_tpu_torch, against
pine_tpu.

- ``io/image_io``: ``load_image`` bit for bit pine_tpu's (PIL) on the
  house's two embedded textures, and on PNGs made here with zlib, one per
  row filter (None, Sub, Up, Average, Paeth) and colour type (gray,
  gray+alpha, RGB, RGBA); ``decode_png`` bit for bit PIL's samples; other
  PNGs and formats refused by name.
- ``io/gltf``: ``iter_glb_meshes``' parts bit for bit pine_tpu's (vertices,
  indices, normals, texcoords), the material types, factors and texture
  images; ``Mesh(file)`` merged alike.
- ``scene/nodes``: ``Texture(UV())`` and ``Texture * factor`` on seeded uv,
  bit for bit.  ``scene/material_eval``: the house's materials (Uber with
  and without textures, emissive) on seeded ctx, u_a and u_b, bit for bit,
  the port's own and pine_tpu's carried by convert.
- ``scene/lights``: ``DirectionalLight.sample``, bit for bit; the compiled
  house's light order and pine_tpu's; its shadow rays to t = 1e10 through
  the house's grid route against the dense sweep.
- ``integrators/cachedpath``: the cache grid's cells bit for bit; its
  argument checks.
- Both house goldens (tests/goldens/house_{path,cached}_48x48x8.npy, written
  by pine_tpu) through the port's interpreter on the CPU, patched as
  tests/test_house.py patches them: RMSE < 0.025, that test's bound.
  Measured: 5.3e-5 (path) and 6.2e-5 (cached).
- What earlier slices refused here (Function nodes, heightmap(size, fn),
  the random walk) builds pine_tpu's values now.

The GPU test renders the reduced house on the card and holds it to the CPU
render by the port's render-parity rule; it skips without a card.
"""
from __future__ import annotations

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from pine_tpu_torch import scenes
from pine_tpu_torch.io import gltf as PG
from pine_tpu_torch.io import image_io as PIO
from pine_tpu_torch.scene import nodes as PN

torch.set_num_threads(2)

GOLDENS = {"path": ("PathIntegrator(BlueSampler(8), 4)", "house_path_48x48x8.npy"),
           "cached": ("CachedPathIntegrator(BlueSampler(8), 4, 32)", "house_cached_48x48x8.npy")}


def png_bytes(samples, filt):
    """An 8-bit PNG of ``samples`` (H,W) or (H,W,C), every row with filter
    ``filt`` (0-4), encoded here with zlib."""
    h, w = samples.shape[:2]
    ch = 1 if samples.ndim == 2 else samples.shape[2]
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = samples.reshape(h, w * ch).astype(np.int64)
    out = b""
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        if filt == 0:
            pred = np.zeros_like(cur)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prev
        elif filt == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([filt]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (PIO.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"tEXt", b"Comment\x00made by the test")
            + chunk(b"IDAT", zlib.compress(out, 9)) + chunk(b"IEND", b""))


def samples_of(shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, shape)
    ramp = np.arange(shape[1])[None, :, None] if len(shape) == 3 else np.arange(shape[1])[None]
    return ((base // 4 + ramp * 7) % 256).astype(np.uint8)


@pytest.mark.parametrize("filt", range(5), ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 2), (9, 13, 3), (9, 13, 4)],
                         ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_png_decoding_matches_pil(tmp_path, shape, filt):
    import io

    from PIL import Image

    from pine_tpu.io.image_io import load_image as jload

    data = png_bytes(samples_of(shape, filt), filt)
    np.testing.assert_array_equal(PIO.decode_png(data), np.asarray(Image.open(io.BytesIO(data))))
    path = tmp_path / "img.png"
    path.write_bytes(data)
    for srgb in (True, False):
        got, want = PIO.load_image(str(path), srgb), jload(str(path), srgb)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_png_refusals(tmp_path):
    head = PIO.PNG_SIGNATURE + struct.pack(">I", 13) + b"IHDR"
    for fields, what in (((4, 4, 16, 2, 0, 0, 0), "16-bit RGB"),
                         ((4, 4, 8, 3, 0, 0, 0), "palette"),
                         ((4, 4, 8, 2, 0, 0, 1), "interlaced")):
        with pytest.raises(ValueError, match=what):
            PIO.decode_png(head + struct.pack(">IIBBBBB", *fields) + b"\0" * 4)
    with pytest.raises(ValueError, match="JPEG"):
        PIO.decode_png(b"\xff\xd8\xff\xe0" + b"\0" * 16)


@pytest.fixture(scope="module")
def glb_parts():
    """(port's parts, pine_tpu's parts) of assets/house.glb."""
    from pine_tpu.io.gltf import iter_glb_meshes

    return PG.iter_glb_meshes(scenes.HOUSE_GLB), iter_glb_meshes(scenes.HOUSE_GLB)


def test_embedded_textures_load_like_pine_tpu(tmp_path):
    from pine_tpu.io.image_io import load_image as jload

    gltf, binary = PG.parse_glb(open(scenes.HOUSE_GLB, "rb").read())
    assert len(gltf["images"]) == 2
    for k, img in enumerate(gltf["images"]):
        bv = gltf["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        path = tmp_path / f"tex{k}.png"
        path.write_bytes(binary[off:off + bv["byteLength"]])
        got, want = PIO.load_image(str(path)), jload(str(path))
        assert got.shape == want.shape == (128, 128, 3)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _bits(a, b, what):
    a = np.ascontiguousarray(np.atleast_1d(np.asarray(a)))
    b = np.ascontiguousarray(np.atleast_1d(np.asarray(b)))
    assert a.shape == b.shape and a.dtype == b.dtype, what
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


def _same_node(p, j, what):
    assert type(p).__name__ == type(j).__name__, what
    if isinstance(p, PN.Constant):
        _bits(p.value, j.value, what)
    elif isinstance(p, PN.Binary):
        assert p.op == j.op
        _same_node(p.a, j.a, what)
        _same_node(p.b, j.b, what)
    elif isinstance(p, PN.Texture):
        _bits(p.image, np.asarray(j.image), what)
        _same_node(p.p, j.p, what)


def test_glb_parts_match_pine_tpu(glb_parts):
    from pine_tpu.io.gltf import mesh_from_glb

    parts, jparts = glb_parts
    assert len(parts) == len(jparts) == 10
    assert sum(m.num_triangles() for m, _ in parts) == 4020
    for k, ((m, mat), (jm, jmat)) in enumerate(zip(parts, jparts)):
        for name in ("vertices", "indices", "normals", "texcoords"):
            _bits(getattr(m, name), getattr(jm, name), f"part {k} {name}")
        assert type(mat).__name__ == type(jmat).__name__ and mat.tag == jmat.tag
        for name in ("albedo", "roughness", "metallic", "color"):
            if hasattr(jmat, name):
                _same_node(getattr(mat, name), getattr(jmat, name), f"part {k} {name}")
    textured = [mat for _, mat in parts if isinstance(getattr(mat, "albedo", None), PN.Binary)]
    assert len(textured) == 4 and len({id(m.albedo.a.image) for m in textured}) == 2
    merged, jmerged = PG.mesh_from_glb(scenes.HOUSE_GLB), mesh_from_glb(scenes.HOUSE_GLB)
    for name in ("vertices", "indices", "normals", "texcoords"):
        _bits(getattr(merged, name), getattr(jmerged, name), f"merged {name}")


def test_texture_nodes_match_pine_tpu(glb_parts):
    import jax.numpy as jnp

    from pine_tpu.scene import nodes as JN

    rng = np.random.default_rng(3)
    n = 4096
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [0.9999999, 0.9999999], [-1e-8, 0.5], [2, -2], [0.5, 1],
              [1e-30, 0.25], [-0.0, 0.75]]
    p = rng.normal(size=(n, 3)).astype(np.float32)
    pctx = dict(p=torch.from_numpy(p), n=torch.from_numpy(p), uv=torch.from_numpy(uv))
    jctx = dict(p=jnp.asarray(p), n=jnp.asarray(p), uv=jnp.asarray(uv))
    (_, mat), (_, jmat) = next((a, b) for a, b in zip(*glb_parts)
                               if isinstance(getattr(a[1], "albedo", None), PN.Binary))
    for node, jnode in ((mat.albedo, jmat.albedo), (mat.albedo.a, jmat.albedo.a),
                        (PN.UV(), JN.UV())):
        got = PN.eval_vec3_node(node, pctx, n).numpy()
        _bits(got, np.asarray(JN.eval_vec3_node(jnode, jctx, n)), type(node).__name__)
    got = PN.eval_scalar_node(mat.roughness, pctx, n).numpy()
    _bits(got, np.asarray(JN.eval_scalar_node(jmat.roughness, jctx, n)), "roughness")


@pytest.fixture(scope="module")
def house_cs():
    """The house compiled by the port on the CPU, and pine_tpu's compiled house."""
    import os

    from pine_tpu.prl.interp import Interpreter

    itp = Interpreter(out=lambda s: None)
    cwd = os.getcwd()
    os.chdir(scenes.ROOT)
    try:
        itp.run(scenes.house_prl(48, None), "<house>")
    finally:
        os.chdir(cwd)
    jscene = itp.get_var("scene")
    return scenes.house(48).compile("cpu"), jscene


def test_material_eval_matches_pine_tpu(house_cs):
    """The house's materials, through the port's compiled scene and through
    pine_tpu's materials carried by convert's records, against pine_tpu's
    eval_bxdf_state on seeded inputs: bit for bit."""
    import jax.numpy as jnp

    from pine_tpu.scene import material_eval as Jme

    from pine_tpu_torch.convert import material_record, node_of
    from pine_tpu_torch.scene import material_eval as Pme
    from pine_tpu_torch.scene import materials as PM

    pcs, jscene = house_cs
    jcs = jscene.compile()
    assert [m["tag"] for m in pcs.materials] == [m.tag for m in jcs.materials]
    assert PM.UBER in [m["tag"] for m in pcs.materials]
    images = []
    carried = []
    for m in jcs.materials:
        rec = material_record(m, images)
        carried.append({k: (node_of(json.loads(str(rec[k + ".node"])), images)
                            if k + ".node" in rec else PN.Constant(rec[k]))
                        for k in PM.PARAMS} | {"tag": int(rec["tag"])})
    assert len(images) == 2

    class Carried:
        materials = carried

    rng = np.random.default_rng(7)
    n = 4096
    mat_idx = rng.integers(0, len(jcs.materials), n).astype(np.int32)
    p, nrm, wi = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    uv = rng.uniform(-1, 2, (n, 2)).astype(np.float32)
    u_a, u_b = rng.uniform(size=(2, n)).astype(np.float32)
    diffused = rng.uniform(size=n) < 0.4
    jst = Jme.eval_bxdf_state(jcs, jnp.asarray(mat_idx), dict(p=jnp.asarray(p), n=jnp.asarray(nrm),
                              uv=jnp.asarray(uv)), jnp.asarray(wi), jnp.asarray(u_a),
                              jnp.asarray(u_b), 0.6, jnp.asarray(diffused))
    t = torch.from_numpy
    for cs in (pcs, Carried):
        pst = Pme.eval_bxdf_state(cs, t(mat_idx), dict(p=t(p), n=t(nrm), uv=t(uv)), t(wi),
                                  t(u_a), t(u_b), 0.6, t(diffused))
        for k in ("tag", "albedo", "roughness", "ior"):
            _bits(pst[k].numpy(), np.asarray(jst[k]), k)
    # both lobes of the house's Uber materials occur: the chimney cap's metal among them
    assert {1, 4} <= set(pst["tag"].numpy().tolist())


def test_lights_match_pine_tpu(house_cs):
    import jax.numpy as jnp

    from pine_tpu.scene import lights as JL

    from pine_tpu_torch.scene import lights as PL

    pcs, jscene = house_cs
    jcs = jscene.compile()
    assert [type(li).__name__ for li in pcs.lights] == ["DirectionalLight", "MeshLight"]
    assert [type(li).__name__ for li in jcs.lights] == ["DirectionalLight", "AreaLight"]
    rng = np.random.default_rng(9)
    p = rng.normal(size=(512, 3)).astype(np.float32)
    u2 = rng.uniform(size=(512, 2)).astype(np.float32)
    u1 = rng.uniform(size=512).astype(np.float32)
    for d in ([0, 1, 5], [0.3, -2.0, 0.7], [1e-3, 1.0, 0.0]):
        pl, jl = PL.DirectionalLight(d, [200, 100, 50]), JL.DirectionalLight(d, [200, 100, 50])
        _bits(pl.direction, jl.direction, "direction")
        ps = pl.sample(torch.from_numpy(p), torch.from_numpy(u2), torch.from_numpy(u1))
        js = jl.sample(jnp.asarray(p), jnp.asarray(u2), jnp.asarray(u1), None)
        for k in ("le", "wo", "distance", "pdf", "valid"):
            _bits(ps[k].numpy(), np.asarray(js[k]), k)
    # the compiled light carries pine_tpu's direction as it is
    _bits(pcs.lights[0].direction, jcs.lights[0].direction, "compiled direction")


def test_directional_shadow_rays_through_the_grid(house_cs):
    """The DirectionalLight's shadow rays run to t = 1e10 * (1 - 1e-3), past
    the scene's bounds: the house's group on its grid route gives the dense
    sweep's occlusion flags for them (no overflow in the culls' slabs)."""
    from pine_tpu_torch.accel import dense_traverse as DT

    pcs, _ = house_cs
    (g,) = pcs.unified["groups"]
    assert g["variant"] == "grid"
    lo, hi = scenes.house(48).get_aabb()
    rng = np.random.default_rng(2)
    n = 512
    ro = torch.from_numpy((lo + (hi - lo) * rng.uniform(size=(n, 3))).astype(np.float32))
    rd = pcs.lights[0].sample(ro, None, None)["wo"].contiguous()
    tmin = torch.zeros(n)
    tmax = torch.full((n,), 1e10 * (1 - 1e-3))
    flags = torch.zeros(n, dtype=torch.int32)
    _, occ = DT.group_query(g, ro, rd, tmin, tmax, tmax, flags, any_hit=True)
    _, want = DT.dense_plain(g["tid"], g["rows"], g["gbox"], ro, rd, tmin, tmax, tmax, flags,
                             True)
    assert torch.equal(occ, want) and 0 < int(occ.sum()) < n


def test_cache_grid_matches_pine_tpu(house_cs):
    import jax.numpy as jnp

    from pine_tpu.integrators.cachedpath import SpatialGrid as JGrid

    from pine_tpu_torch.integrators.cachedpath import SpatialGrid

    _, jscene = house_cs
    lo, hi = scenes.house(48).get_aabb()
    _bits(lo, jscene.get_aabb()[0], "lo")
    _bits(hi, jscene.get_aabb()[1], "hi")
    rng = np.random.default_rng(1)
    p = (lo + (hi - lo) * rng.uniform(-0.1, 1.1, (4096, 3))).astype(np.float32)
    u3 = rng.uniform(size=(4096, 3)).astype(np.float32)
    for res in (128, 32, 1):
        g, jg = SpatialGrid(lo, hi, res, "cpu"), JGrid(lo, hi, res)
        assert g.res == jg.res and g.n_cells() == jg.n_cells()
        _bits(g.cell_of(torch.from_numpy(p)).numpy(), np.asarray(jg.cell_of(jnp.asarray(p))),
              "cell")
        _bits(g.jittered_cell_of(torch.from_numpy(p), torch.from_numpy(u3)).numpy(),
              np.asarray(jg.jittered_cell_of(jnp.asarray(p), jnp.asarray(u3))), "jittered")


@pytest.mark.parametrize("integrator", list(GOLDENS))
def test_house_golden(integrator):
    """tests/test_house.py's goldens through the port's interpreter (its
    patches: 48x48, the integrator named, no save) on the CPU."""
    import os

    expr, name = GOLDENS[integrator]
    img = scenes.house(48, expr, device="cpu").camera.film.finalized()
    assert img.shape == (48, 48, 3) and np.isfinite(img).all()
    ref = np.load(os.path.join(os.path.dirname(__file__), "goldens", name)).astype(np.float32)
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    assert rmse < 0.025, rmse


def test_prl_texture_script_matches_pine_tpu(tmp_path):
    """A script's ``load_image``, ``Texture``, ``UV``, node arithmetic, Uber,
    an image as a material parameter, ``DirectionalLight`` and ``get_aabb``
    through both interpreters: the port's flattened material and light
    records equal convert's records of pine_tpu's compiled scene."""
    from pine_tpu.prl.interp import Interpreter as JInterpreter

    from pine_tpu_torch.convert import light_record, material_record, scene_arrays
    from pine_tpu_torch.prl.interp import Interpreter

    path = tmp_path / "tex.png"
    path.write_bytes(png_bytes(samples_of((6, 5, 3), 4), 4))
    src = f"""
    scene := Scene();
    img := load_image("{path}");
    scene.add("tex", Uber(Texture(UV(), img) * 0.5 + [0.1, 0.2, 0.3], 0.3, 0.2, 0.1));
    scene.add(Rect([0, 0, 0], [1, 0, 0], [0, 0, 1]), "tex");
    scene.add(Sphere([0, 1, 0], 0.5), Diffuse(img));
    scene.add(DirectionalLight([0.3, 1, 0.2], [2, 2, 2]));
    box := get_aabb(scene);
    scene.set(ThinLenCamera(Film([8, 8]), [0, 1, -3], [0, 0, 0], 0.5));
    """
    itp, jitp = Interpreter(device="cpu"), JInterpreter(out=lambda s: None)
    itp.run(src, "<tex>")
    jitp.run(src, "<tex>")
    a, jcs = scene_arrays(itp.get_var("scene")), jitp.get_var("scene").compile()
    images = []
    for i, m in enumerate(jcs.materials):
        for k, v in material_record(m, images).items():
            _bits(a[f"mat.{i}.{k}"], v, f"mat.{i}.{k}")
    assert int(a["n_images"]) == len(images) == 1
    _bits(a["image.0"], images[0], "image")
    for i, li in enumerate(jcs.lights):
        for k, v in light_record(li).items():
            _bits(a[f"light.{i}.{k}"], v, f"light.{i}.{k}")
    box, jbox = itp.get_var("box"), jitp.get_var("box")
    _bits(box.params(), jbox.params(), "get_aabb")


def test_cached_path_argument_checks():
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.cachedpath import CachedPathIntegrator

    for args, what in (((0,), "max_path_length"), ((4, 0), "max_axis_resolution"),
                       ((4, 8, -1), "starting_depth")):
        with pytest.raises(ValueError, match=what):
            CachedPathIntegrator(BlueSampler(4), *args)


def test_remaining_refusals_name_their_item():
    """What this test once held refused (script functions as nodes,
    heightmap(size, fn), the random walk) is ported: the same lines build
    pine_tpu's values, and a Python callable is a Function node."""
    import jax.numpy as jnp
    from pine_tpu.scene import nodes as JN
    from test_torch_lambdas import lines_agree, run_line, values_agree

    lines_agree('s := Scene(); m := Diffuse(Function((c: NodeEvalCtx): vec3 { return c.p; }));'
                ' s.add("skin", m); r := m.albedo;')
    lines_agree("r := heightmap([8, 8], (p: vec2): f32 { return p.x; });")
    p, j = run_line("s := Scene(); r := RandomWalkIntegrator(BlueSampler(4), 4);")
    values_agree(p.get_var("r"), j.get_var("r"))
    with pytest.raises(RuntimeError, match="camera"):  # a scene without a camera
        p.get_var("r").render(p.get_var("s"), device="cpu")
    values_agree(PN.as_node(lambda ctx: 1.0), JN.Function(lambda ctx: jnp.float32(1.0)))


@pytest.mark.cuda
def test_house_renders_on_card_like_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for expr, _ in GOLDENS.values():
        got = scenes.house(48, expr).camera.film.rgb.cpu().numpy()
        want = scenes.house(48, expr, device="cpu").camera.film.rgb.numpy()
        d = np.abs(got - want)
        assert np.isfinite(got).all()
        assert ((d <= 1e-3 * np.abs(want)) | (d <= 1e-4)).all(-1).mean() >= 0.97
