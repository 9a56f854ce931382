"""Validation / debug subsystem (SURVEY.md §5 race-detection row).

The reference's only safety nets are the D3D debug layer and HRESULT
MessageBoxes (CSVersion/Dx11Base.cpp:69-72 etc.); its one latent fault is
the oversized dispatch writing out-of-bounds UAV rows that D3D silently
drops (DxCSApp.cpp:524).  Here:

- :func:`checked_render` — the golden renderer under ``jax.checkify``
  with float checks: NaN/Inf anywhere in the pipeline raises with a
  located error instead of silently propagating black/garbage pixels;
- :func:`validate_backends` — cross-backend consistency sweep (golden vs
  the engine: compiled on a GPU, interpreted on the CPU), the renderer's
  analogue of a race/miscompile detector: the engine's predicated
  updates and refill loop must never change pixel values;
- :func:`validate_scene` — host-side scene sanity (finite fields, radii
  != 0, known material ids, in-range IORs).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import checkify

from raytpu.camera import Camera
from raytpu.config import RenderConfig
from raytpu.scene import Scene, DIFFUSE, METAL, DIELECTRIC
from raytpu import golden


@functools.partial(jax.jit, static_argnums=(2,))
def _checked(scene, cam, cfg):
    f = checkify.checkify(
        lambda s, c: golden.render_golden(s, c, cfg),
        errors=checkify.float_checks)
    return f(scene, cam)


def checked_render(scene: Scene, cam: Camera, cfg: RenderConfig):
    """Render with NaN/Inf detection; raises on the first bad value."""
    err, img = _checked(scene, cam, cfg)
    checkify.check_error(err)
    return img


def validate_scene(scene: Scene) -> list[str]:
    """Host-side scene lint -> list of human-readable problems."""
    problems = []
    center = np.asarray(scene.center)
    radius = np.asarray(scene.radius)
    mat = np.asarray(scene.mat_type)
    albedo = np.asarray(scene.albedo)
    param = np.asarray(scene.mat_param)
    if not np.isfinite(center).all():
        problems.append("non-finite sphere center")
    if not np.isfinite(radius).all():
        problems.append("non-finite radius")
    if (radius == 0).any():
        problems.append("zero radius sphere (degenerate normal)")
    bad = ~np.isin(mat, (DIFFUSE, METAL, DIELECTRIC))
    if bad.any():
        problems.append(
            f"unknown material ids {sorted(set(mat[bad].tolist()))} "
            "(rays absorb to black, ref hlsl:251)")
    if ((albedo < 0) | ~np.isfinite(albedo)).any():
        problems.append("negative/non-finite albedo")
    if (albedo > 1).any():
        problems.append(
            "albedo > 1 (energy-amplifying; the reference's random_world "
            "metal quirk, DxCSApp.cpp:118 — allowed but noteworthy)")
    glass = mat == DIELECTRIC
    if (param[glass] <= 0).any():
        problems.append("dielectric with IOR <= 0")
    return problems


def validate_backends(scene: Scene, cam: Camera, cfg: RenderConfig,
                      atol_compiled: float = 3e-4,
                      max_outlier_frac: float = 0.05) -> dict:
    """Cross-backend consistency sweep -> report dict.

    On a GPU the compiled engine is compared with golden on the card:
    their f32 evaluation orders differ (FMA contraction, scheduling), so
    a few paths take other branches; the sweep passes while at most
    ``max_outlier_frac`` of the pixels differ by more than
    ``atol_compiled`` (the bound chip_smoke.py measures and states).  On
    the CPU the engine runs in the Pallas interpreter and must be
    BIT-identical to golden (same op sequence).
    """
    from raytpu.kernels import megakernel

    ref = np.asarray(golden.render_golden(scene, cam, cfg))
    report = {"golden_finite": bool(np.isfinite(ref).all())}
    if jax.devices()[0].platform == "gpu":
        comp = np.asarray(megakernel.render_pallas(scene, cam, cfg))
        diff = np.abs(comp - ref)
        report["compiled_max_diff"] = float(diff.max())
        report["compiled_outlier_frac"] = float(
            (diff > atol_compiled).mean())
        report["compiled_ok"] = bool(
            np.isfinite(comp).all()
            and report["compiled_outlier_frac"] <= max_outlier_frac)
    else:
        interp = np.asarray(
            megakernel.render_pallas(scene, cam, cfg, interpret=True))
        report["interpret_bit_identical"] = bool(
            np.array_equal(interp, ref))
    return report
