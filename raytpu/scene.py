"""Scene representation and builders.

The scene is a SoA PyTree of f32/i32 arrays — the JAX analogue of the
reference's ``WorldDef`` cbuffer (ref: CSVersion/ShaderCompute.hlsl:12-19 and
CSVersion/DxCSApp.cpp:64-70): ``spheres[512]`` float4 (xyz=center, w=radius),
``matTypes`` packed scalars, ``matValues`` float4 (rgb=albedo, w=fuzz|IOR).
We split the packed float4s into named arrays; gradients then flow separately
to centers, radii, albedo, and fuzz/IOR, which is the differentiable-rendering
API surface mandated by BASELINE.json.

Builders mirror the reference scene constructors:
- ``test_world``    (ref: CSVersion/DxCSApp.cpp:136-157)
- ``random_world``  (ref: CSVersion/DxCSApp.cpp:72-134)
plus the BASELINE.json config scenes (config1, config2, final 500-sphere).

Host-side randomness in builders uses a seeded ``numpy.random.Generator`` —
the reference's ``random()`` is an unseeded host RNG, so scene *contents*
(not semantics) are implementation-defined; ours are deterministic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

DIFFUSE = 0
METAL = 1
DIELECTRIC = 2


class Scene(NamedTuple):
    """SoA sphere scene. All leaves are arrays with leading dim N (static)."""

    center: jnp.ndarray     # (N, 3) f32 sphere centers
    radius: jnp.ndarray     # (N,)   f32 sphere radii
    mat_type: jnp.ndarray   # (N,)   i32 0=diffuse 1=metal 2=dielectric
    albedo: jnp.ndarray     # (N, 3) f32 material color (unused by dielectric)
    mat_param: jnp.ndarray  # (N,)   f32 metal fuzz OR dielectric IOR

    @property
    def count(self) -> int:
        return self.center.shape[0]


def make_scene(spheres) -> Scene:
    """Build a Scene from a list of
    ``(center_xyz, radius, mat_type, albedo_rgb, mat_param)`` tuples."""
    center = np.array([s[0] for s in spheres], np.float32).reshape(-1, 3)
    radius = np.array([s[1] for s in spheres], np.float32)
    mat_type = np.array([s[2] for s in spheres], np.int32)
    albedo = np.array([s[3] for s in spheres], np.float32).reshape(-1, 3)
    mat_param = np.array([s[4] for s in spheres], np.float32)
    return Scene(
        center=jnp.asarray(center),
        radius=jnp.asarray(radius),
        mat_type=jnp.asarray(mat_type),
        albedo=jnp.asarray(albedo),
        mat_param=jnp.asarray(mat_param),
    )


def test_world() -> Scene:
    """4-sphere book scene (ref: CSVersion/DxCSApp.cpp:136-157).

    Note the reference's "hollow glass" comment is a misnomer — there is no
    inner negative-radius sphere; it is plain glass (SURVEY.md quirk list).
    """
    return make_scene([
        ((0.0, -1000.5, -1.0), 1000.0, DIFFUSE, (0.5, 0.5, 0.5), 1.0),
        ((0.0, 0.0, -1.0), 0.5, DIFFUSE, (0.2, 0.4, 0.8), 1.0),
        ((1.0, 0.0, -1.0), 0.5, METAL, (0.8, 0.4, 0.2), 0.0),
        ((-1.0, 0.0, -1.0), 0.5, DIELECTRIC, (0.5, 0.5, 0.5), 1.5),
    ])


def v1_world() -> Scene:
    """The v1 pixel-shader generation's hardcoded seven-sphere scene
    (ref: Shader_RT.fx:300-335 ``random_world()`` — despite its name it
    is fully deterministic; the loops+randoms version is commented out
    with a TODO at Shader_RT.fx:310).

    Contents, in the reference's build order: ground lambert r=1000,
    three r=0.2 lamberts (blue / green / rust), then the three hero
    spheres — glass (IOR 1.5), brown lambert, and polished metal
    (fuzz 0).  ``AddDielectric`` sets albedo=(1,1,1,1)
    (Shader_RT.fx:96-104); kept here for fidelity though dielectric
    attenuation ignores albedo in both generations.
    """
    return make_scene([
        ((0.0, -1000.0, 0.0), 1000.0, DIFFUSE, (0.5, 0.5, 0.5), 0.0),
        ((3.0, 0.2, 1.5), 0.2, DIFFUSE, (0.2, 0.2, 0.8), 0.0),
        ((4.5, 0.2, 1.0), 0.2, DIFFUSE, (0.2, 0.8, 0.2), 0.0),
        ((4.5, 0.2, 2.0), 0.2, DIFFUSE, (0.8, 0.3, 0.2), 0.0),
        ((0.0, 1.0, 0.0), 1.0, DIELECTRIC, (1.0, 1.0, 1.0), 1.5),
        ((-4.0, 1.0, 0.0), 1.0, DIFFUSE, (0.4, 0.2, 0.1), 0.0),
        ((4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), 0.0),
    ])


def config1_world() -> Scene:
    """BASELINE config 1: one Lambertian sphere + ground sphere."""
    return make_scene([
        ((0.0, -100.5, -1.0), 100.0, DIFFUSE, (0.5, 0.5, 0.5), 1.0),
        ((0.0, 0.0, -1.0), 0.5, DIFFUSE, (0.7, 0.3, 0.3), 1.0),
    ])


def config2_world() -> Scene:
    """BASELINE config 2: Lambertian + metal + dielectric (+ ground)."""
    return test_world()


def random_world(seed: int = 0, half_extent: int = 9) -> Scene:
    """Random hero + grid scene (ref: CSVersion/DxCSApp.cpp:72-134).

    Ground r=1000 + 3 hero spheres (glass / lambert / metal) + a jittered
    ``(2*half_extent)^2`` grid of r=0.2 spheres: 80% diffuse (albedo =
    rand*rand), 15% metal (albedo = rand/2 + 1 — the reference's
    energy-amplifying quirk, ref: DxCSApp.cpp:118), 5% glass (IOR 1.5).
    Grid spheres within 0.9 of (4, 0.2, 0) are skipped.
    """
    rg = np.random.default_rng(seed)
    spheres = [
        ((0.0, -1000.0, 0.0), 1000.0, DIFFUSE, (0.5, 0.5, 0.5), 1.0),
        ((0.0, 1.0, 0.0), 1.0, DIELECTRIC, (0.0, 0.0, 0.0), 1.5),
        ((-4.0, 1.0, 0.0), 1.0, DIFFUSE, (0.4, 0.2, 0.1), 1.0),
        ((4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), 0.0),
    ]
    for a in range(-half_extent, half_extent):
        for b in range(-half_extent, half_extent):
            mat_choice = rg.random()
            center = (a + 0.9 * rg.random(), 0.2, b + 0.9 * rg.random())
            if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) <= 0.9:
                continue
            if mat_choice < 0.8:
                albedo = tuple(rg.random(3) * rg.random(3))
                spheres.append((center, 0.2, DIFFUSE, albedo, 0.0))
            elif mat_choice < 0.95:
                albedo = tuple(rg.random(3) / 2 + 1)
                spheres.append((center, 0.2, METAL, albedo, 0.0))
            else:
                spheres.append((center, 0.2, DIELECTRIC, (0.0, 0.0, 0.0), 1.5))
    return make_scene(spheres)


def final_world(seed: int = 0, n: int = 500) -> Scene:
    """BASELINE config 4/5: exactly ``n`` spheres (grid scene, topped up or
    truncated to ``n`` with extra random r=0.2 diffuse spheres)."""
    base = random_world(seed=seed, half_extent=11)
    spheres = list(zip(
        np.asarray(base.center).tolist(),
        np.asarray(base.radius).tolist(),
        np.asarray(base.mat_type).tolist(),
        np.asarray(base.albedo).tolist(),
        np.asarray(base.mat_param).tolist(),
    ))
    rg = np.random.default_rng(seed + 1)
    while len(spheres) < n:
        center = (rg.uniform(-11, 11), 0.2, rg.uniform(-11, 11))
        if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) <= 0.9:
            continue
        albedo = tuple(rg.random(3) * rg.random(3))
        spheres.append((center, 0.2, DIFFUSE, albedo, 0.0))
    return make_scene(spheres[:n])
