"""Materials.  Counterpart of pine_tpu/scene/materials.py.

Host-side materials whose parameters are nodes (scene/nodes.py): constants,
image textures, procedural nodes and their arithmetic.  Diffuse, Metal,
Glossy, Glass, Emissive, Uber and Subsurface; the wavefront evaluates their
nodes per lane and picks Uber's and Subsurface's lobes from the lane's
sampler dims (scene/material_eval.py).  An emissive material's color node is
evaluated where its light is sampled and where a ray hits it.
"""
from __future__ import annotations

import numpy as np

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
    """A dielectric boundary over a scattering interior (material.cpp:9-29):
    per lane a Fresnel-chosen rough reflection, else the BSSRDF lobe (a
    diffuse lobe once the path has had a diffuse bounce), whose vertex the
    random walk of integrators/path.bssrdf_walk moves to an exit point.
    ``sigma_s`` is the constant scattering coefficient, one value or three;
    the boundary's ior is 1.4."""

    tag = SUBSURFACE

    def __init__(self, albedo, roughness, sigma_s):
        self.albedo = N.as_node(albedo)
        self.roughness = N.as_node(roughness)
        sig = sigma_s.value if isinstance(sigma_s, N.Constant) else sigma_s
        sig = np.asarray(sig, np.float32).reshape(-1)
        self.sigma_s = np.broadcast_to(sig, (3,)).astype(np.float32).copy()
        self.ior = 1.4


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
              color=(0.0, 0.0, 0.0), sigma_s=(0.0, 0.0, 0.0))
