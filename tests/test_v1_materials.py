"""v1 (pixel-shader generation) material semantics — scatter_mode="v1".

The v1 materials differ from v2 (ref: Shader_RT.fx:217-243 vs
CSVersion/ShaderCompute.hlsl:207-252): hemisphere-flipped diffuse with a
near-zero degenerate guard, saturated metal fuzz, and neither scatter
direction normalized.  These tests pin the flag end to end: golden vs
the independent scalar transcription, the Pallas engine vs golden, and
the adjoint's gradients vs generic autodiff.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytpu
from raytpu import golden, adjoint
from raytpu.config import RenderConfig
from raytpu.kernels import megakernel
import hlsl_ref
from test_golden import _cam_dict, _scene_dict


def _scene():
    # fuzzy metal included: fuzz saturation + hemisphere sampling differ
    return raytpu.make_scene([
        ((0.0, -1000.5, -1.0), 1000.0, 0, (0.5, 0.5, 0.5), 1.0),
        ((0.0, 0.0, -1.0), 0.5, 0, (0.2, 0.4, 0.8), 1.0),
        ((1.0, 0.0, -1.0), 0.5, 1, (0.8, 0.4, 0.2), 1.7),
        ((-1.0, 0.0, -1.0), 0.5, 2, (0.5, 0.5, 0.5), 1.5),
    ])


def _cam(aspect):
    return raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                              vfov=20.0, aspect=aspect,
                              aperture=0.1, focus_dist=10.0)


def test_v1_differs_from_v2():
    cfg2 = RenderConfig(width=64, height=48, spp=2, depth=6)
    cfg1 = cfg2.replace(scatter_mode="v1")
    scene, cam = _scene(), _cam(cfg2.aspect)
    a = np.asarray(golden.render_golden(scene, cam, cfg2))
    b = np.asarray(golden.render_golden(scene, cam, cfg1))
    assert np.abs(a - b).max() > 1e-3


def test_v1_golden_matches_scalar_oracle():
    cfg = RenderConfig(width=96, height=72, spp=3, depth=6,
                       scatter_mode="v1")
    scene, cam = _scene(), _cam(cfg.aspect)
    img = np.asarray(golden.render_golden(scene, cam, cfg))
    rs = np.random.default_rng(1)
    sd, cd = _scene_dict(scene), _cam_dict(cam)
    bad = 0
    for x, y in zip(rs.integers(0, cfg.width, 24),
                    rs.integers(0, cfg.height, 24)):
        want = hlsl_ref.render_pixel(sd, cd, int(x), int(y), cfg.width,
                                     cfg.height, cfg.spp, cfg.depth,
                                     scatter_mode="v1")
        if not np.allclose(img[int(y), int(x)], want, atol=5e-3):
            bad += 1
    assert bad == 0


def test_v1_megakernel_bit_equals_golden():
    cfg = RenderConfig(width=64, height=48, spp=2, depth=5,
                       scatter_mode="v1")
    scene, cam = _scene(), _cam(cfg.aspect)
    ref = np.asarray(golden.render_golden(scene, cam, cfg))
    img = np.asarray(megakernel.render_pallas(scene, cam, cfg,
                                              interpret=True))
    np.testing.assert_array_equal(img, ref)


def test_v1_adjoint_grads_match_autodiff():
    cfg = RenderConfig(width=48, height=24, spp=2, depth=4,
                       scatter_mode="v1")
    scene, cam = _scene(), _cam(cfg.aspect)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    def loss_a(s):
        img = adjoint.render_golden_adjoint(s, cam, cfg)
        return jnp.mean((img - target) ** 2)

    def loss_g(s):
        img = golden.render_golden(s, cam, cfg)
        return jnp.mean((img - target) ** 2)

    ga = jax.grad(loss_a, allow_int=True)(scene)
    gg = jax.grad(loss_g, allow_int=True)(scene)
    for k in ("center", "radius", "albedo", "mat_param"):
        a, b = np.array(getattr(ga, k)), np.array(getattr(gg, k))
        scale = max(np.abs(b).max(), 1e-8)
        assert np.abs(a - b).max() / scale < 1e-4, k
