"""Public rendering entry points.

The reference's L2/L3 host layers (CSVersion/DxCSApp.cpp orchestration +
CSVersion/main.cpp shell) collapse into these functions: build a Scene and a
Camera, call :func:`render`.  Backends:

- ``"golden"`` — the pure-jnp oracle (raytpu/golden.py), runs anywhere.
- ``"pallas"`` — the Pallas-Triton engine (raytpu/kernels/megakernel.py):
  one fused kernel per frame with persistent sample refill.  It compiles
  for the GPU; ``interpret=True`` runs it in the Pallas interpreter.
- ``"auto"``   — the engine on a GPU (or wherever ``interpret=True``
  asks for its interpreter), golden on the CPU; any other platform is an
  error.

``render_grad`` returns (image, pulled-back gradients) of a scalar loss over
the image w.r.t. (scene, camera) — the differentiable-rendering surface
(gradients of pixels w.r.t. sphere centers/radii, albedo/fuzz/IOR, camera
pose) mandated by BASELINE.json; the reference has no equivalent.  Its
backward is the hand-structured adjoint (raytpu/adjoint.py) on every
backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from raytpu.camera import Camera
from raytpu.config import RenderConfig
from raytpu.scene import Scene
from raytpu import golden

BACKENDS = ("auto", "golden", "pallas")


def _backend(name: str, interpret: bool = False) -> str:
    """Resolve a backend name for the default device's platform."""
    if name not in BACKENDS:
        raise ValueError(f"unknown backend: {name!r} (choose from "
                         f"{BACKENDS})")
    platform = jax.devices()[0].platform
    if name == "auto":
        if platform == "gpu" or interpret:
            return "pallas"
        if platform == "cpu":
            return "golden"
        raise ValueError(f"no renderer for platform {platform!r}; "
                         "raytpu runs on a GPU or the CPU")
    if name == "pallas" and platform != "gpu" and not interpret:
        raise ValueError(
            f"the Pallas engine compiles for the GPU, not {platform!r}; "
            "pass interpret=True to run it in the Pallas interpreter")
    return name


def render(scene: Scene, cam: Camera, cfg: RenderConfig,
           backend: str = "auto", interpret: bool = False,
           vis_w: float = 0.0) -> jnp.ndarray:
    """Render -> (H, W, 3) f32 image in [0, 1].

    Row 0 is the bottom scanline (v = 0); use :func:`raytpu.io.save_image`
    to write a display-oriented file.  ``interpret=True`` runs the
    engine in the Pallas interpreter (tests on the CPU).  ``vis_w > 0``
    gives ``jax.grad`` through the render the adjoint's silhouette
    gradients (the image is unchanged).
    """
    backend = _backend(backend, interpret)
    if cfg.rng_mode == "v1_fractsin":
        # the v1 fract-sin parity mode lives on the golden path only:
        # its float-sin draw chain is the numerical fragility the
        # engine's counter-based RNG exists to avoid (raytpu/rng.py)
        backend = "golden"
    if backend == "golden":
        if vis_w > 0:
            from raytpu import adjoint
            return adjoint.render_golden_adjoint(scene, cam, cfg,
                                                 float(vis_w))
        return golden.render_golden(scene, cam, cfg)
    from raytpu.kernels import megakernel
    return megakernel.render_pallas(scene, cam, cfg, interpret=interpret,
                                    vis_w=vis_w)


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _grad_impl(scene, cam, target, cfg, backend, vis_w, interpret):
    def loss_fn(scene_, cam_):
        if backend == "golden":
            # hand-structured adjoint: forward bit-identical to golden,
            # backward O(P*depth) (raytpu/adjoint.py)
            from raytpu import adjoint
            img = adjoint.render_golden_adjoint(scene_, cam_, cfg, vis_w)
        else:
            from raytpu.kernels import megakernel
            img = megakernel.render_pallas(scene_, cam_, cfg,
                                           interpret=interpret, vis_w=vis_w)
        loss = jnp.mean((img - target) ** 2)
        return loss, img

    # allow_int: Scene.mat_type is i32 (discrete, gradient-free by design)
    (loss, img), grads = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True, allow_int=True)(scene, cam)
    return loss, img, grads


def render_grad(scene: Scene, cam: Camera, cfg: RenderConfig, target,
                backend: str = "auto", vis_w: float = 0.0,
                interpret: bool = False):
    """MSE loss against ``target`` + gradients w.r.t. (scene, camera).

    Returns (loss, image, (scene_grads, camera_grads)).  ``vis_w > 0``
    adds silhouette (boundary) gradients for geometry optimization —
    forward values stay the exact hard render (see raytpu/adjoint.py).
    On the engine the image comes from the engine and the backward from
    the adjoint, so the gradients equal ``jax.grad`` through
    :func:`render`.
    """
    backend = _backend(backend, interpret)
    if cfg.rng_mode == "v1_fractsin":
        raise ValueError(
            "rng_mode='v1_fractsin' is a forward reference-parity mode; "
            "use the sequential/parallel RNG modes for gradients")
    return _grad_impl(scene, cam, jnp.asarray(target, jnp.float32),
                      cfg, backend, float(vis_w), bool(interpret))
