"""raytpu — a differentiable sphere path tracer in JAX.

A from-scratch JAX / Pallas reimplementation of the capabilities of the
reference renderer Brochu/RayTrace-WE-GPU (a DirectX 11 "Ray Tracing in
One Weekend" compute-shader path tracer).  The reference defines the
forward rendering *semantics* (see SURVEY.md); here:

- SoA scene PyTrees (mirroring the reference's cbuffer layout,
  ref: CSVersion/ShaderCompute.hlsl:12-19)
- a counter-based, coordinate-derived hash RNG identical across golden /
  engine / sharded execution (ref: CSVersion/ShaderCompute.hlsl:23-66)
- a pure-jnp golden renderer as the allclose oracle
- a Pallas-Triton engine for the GPU hot path (raytpu/kernels/)
- a hand-structured custom_vjp adjoint (gradients of pixels w.r.t.
  sphere centers/radii, material albedo/fuzz/IOR, and camera pose)
- pixel-slab sharding over a jax.sharding.Mesh with psum'd scene
  gradients
"""

import os as _os

import jax as _jax


def compile_cache_dir(environ=_os.environ) -> str | None:
    """Where the persistent XLA compile cache lives: nothing to set when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself), else a
    fixed ``.jax_cache/`` inside the checkout (fixed, because the path
    is part of the cache key)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


_cache = compile_cache_dir()
if _cache is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache)

from raytpu.config import RenderConfig
from raytpu.camera import (
    Camera,
    make_camera,
    reference_camera_v1,
    reference_camera_v2,
)
from raytpu.scene import (
    Scene,
    make_scene,
    test_world,
    random_world,
    config1_world,
    config2_world,
    final_world,
    v1_world,
)
from raytpu.render import render, render_grad
from raytpu.bvh import BVH, build_bvh

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "make_camera",
    "reference_camera_v1",
    "reference_camera_v2",
    "Scene",
    "make_scene",
    "test_world",
    "random_world",
    "config1_world",
    "config2_world",
    "final_world",
    "v1_world",
    "render",
    "render_grad",
    "BVH",
    "build_bvh",
]
