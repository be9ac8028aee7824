"""Brute-force random-walk integrator.  Counterpart of
pine_tpu/integrators/randomwalk.py (parity: impl/integrator/randomwalk.cpp).

The reference's radiance body is commented out and returns 0
(randomwalk.cpp:14-48); pine_tpu implements the intended brute-force path
tracer, and so does the port: the path integrator's wavefront without next
event estimation, so emission is picked up only where a BSDF sample hits an
emitter.
"""
from __future__ import annotations

from pine_tpu_torch.integrators.path import PathIntegrator, render_wavefront


class RandomWalkIntegrator(PathIntegrator):
    """RandomWalkIntegrator(sampler, max_path_length): path tracing without NEE."""

    def render(self, scene, device=None):
        """Render ``scene`` into its camera's film on ``device`` (default: the card)."""
        cam = scene.camera
        if cam is None:
            raise RuntimeError("scene has no camera")
        cscene = scene.compile(device)
        film = cam.film
        film.set_rgb(render_wavefront(cscene, cam, film.width, film.height, self.sampler,
                                      self.sampler.spp, self.max_path_length, nee=False))
        return film
