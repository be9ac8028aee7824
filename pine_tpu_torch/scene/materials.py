"""Materials.  Counterpart of pine_tpu/scene/materials.py.

Host-side materials whose parameters are nodes (scene/nodes.py): constants,
image textures and their products.  Diffuse, Metal, Glossy, Glass, Emissive
and Uber are ported; the wavefront evaluates their nodes per lane and picks
Uber's lobe from the lane's sampler dims (scene/material_eval.py).
Subsurface is not yet (ROADMAP.md, modules item 3): a scene that renders
with one is refused at compile().  An emissive material's color must be a
constant (its light is sampled with one color).
"""
from __future__ import annotations

from pine_tpu_torch.scene import nodes as N

# Material tags
EMISSIVE = 0
DIFFUSE = 1
METAL = 2
GLOSSY = 3
GLASS = 4
UBER = 5
SUBSURFACE = 6

# BXDF tags
BX_DIFFUSE = 0
BX_CONDUCTOR = 1
BX_REFRACTIVE = 2
BX_REFR_DIELECTRIC = 3
BX_DIFF_DIELECTRIC = 4
BX_BSSRDF = 5


class Material:
    tag: int = -1

    def is_emissive(self):
        return self.tag == EMISSIVE


class Emissive(Material):
    tag = EMISSIVE

    def __init__(self, color):
        self.color = N.as_node(color)


class Diffuse(Material):
    tag = DIFFUSE

    def __init__(self, albedo):
        self.albedo = N.as_node(albedo)


class Metal(Material):
    tag = METAL

    def __init__(self, albedo, roughness):
        self.albedo = N.as_node(albedo)
        self.roughness = N.as_node(roughness)


class Glossy(Material):
    tag = GLOSSY

    def __init__(self, albedo, roughness, ior=1.4):
        self.albedo = N.as_node(albedo)
        self.roughness = N.as_node(roughness)
        self.ior = N.as_node(ior)


class Glass(Material):
    tag = GLASS

    def __init__(self, albedo, roughness, ior=1.4):
        self.albedo = N.as_node(albedo)
        self.roughness = N.as_node(roughness)
        self.ior = N.as_node(ior)


class Subsurface(Material):
    """Declared so scripts that name it build; rendering with it is refused."""

    tag = SUBSURFACE

    def __init__(self, albedo, roughness, sigma_s):
        self.albedo, self.roughness, self.sigma_s = albedo, roughness, sigma_s


class Uber(Material):
    """A metallic / transmissive / dielectric blend (material.cpp:9-29): per
    lane, a conductor where u_a < metallic, else a refractive dielectric
    where u_b < transmission, else a diffuse dielectric."""

    tag = UBER

    def __init__(self, albedo, roughness, metallic=0.0, transmission=0.0, ior=1.45):
        self.albedo = N.as_node(albedo)
        self.roughness = N.as_node(roughness)
        self.metallic = N.as_node(metallic)
        self.transmission = N.as_node(transmission)
        self.ior = float(ior)


# a material's node parameters and the value of each it lacks
PARAMS = dict(albedo=(0.0, 0.0, 0.0), roughness=0.0, metallic=0.0, transmission=0.0, ior=1.4,
              color=(0.0, 0.0, 0.0))


def check_ported(mat):
    """Refuse materials the port cannot render yet."""
    if mat.tag == SUBSURFACE:
        raise NotImplementedError(
            f"{type(mat).__name__} material is not ported yet (ROADMAP.md, modules item 3)")
    return mat
