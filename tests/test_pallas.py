"""The Pallas engine vs the golden oracle (interpret mode on CPU).

The engine mirrors golden.py op-for-op, so images are bit-identical in
interpret mode; compiled on the GPU, Triton's f32 evaluation order differs
from XLA's in the last bits, so chip_smoke.py compares within a stated
tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytpu
from raytpu import golden
from raytpu.config import RenderConfig
from raytpu.kernels import megakernel


def _cam(cfg, **kw):
    return raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=cfg.aspect, **kw)


def test_matches_golden_test_world():
    cfg = RenderConfig(width=64, height=36, spp=2, depth=4)
    scene = raytpu.test_world()
    cam = _cam(cfg)
    want = np.asarray(golden.render_golden(scene, cam, cfg))
    got = np.asarray(megakernel.render_pallas(scene, cam, cfg,
                                                 interpret=True))
    np.testing.assert_array_equal(got, want)


def test_matches_golden_unaligned_size():
    """Pixel count not a multiple of the block: pad + slice must be exact."""
    cfg = RenderConfig(width=50, height=21, spp=2, depth=3)
    scene = raytpu.config1_world()
    cam = raytpu.make_camera((0.0, 0.2, 1.0), (0.0, 0.0, -1.0), vfov=60.0,
                             aspect=cfg.aspect)
    want = np.asarray(golden.render_golden(scene, cam, cfg))
    got = np.asarray(megakernel.render_pallas(scene, cam, cfg,
                                                 interpret=True))
    np.testing.assert_array_equal(got, want)


def test_matches_golden_defocus():
    cfg = RenderConfig(width=64, height=24, spp=2, depth=3)
    scene = raytpu.config1_world()
    cam = raytpu.make_camera((0.0, 0.5, 2.0), (0.0, 0.0, -1.0), vfov=40.0,
                             aspect=cfg.aspect, aperture=0.4, focus_dist=3.0)
    want = np.asarray(golden.render_golden(scene, cam, cfg))
    got = np.asarray(megakernel.render_pallas(scene, cam, cfg,
                                                 interpret=True))
    np.testing.assert_array_equal(got, want)


def test_matches_golden_many_spheres():
    cfg = RenderConfig(width=32, height=16, spp=1, depth=3)
    scene = raytpu.random_world(seed=3, half_extent=4)
    cam = _cam(cfg)
    want = np.asarray(golden.render_golden(scene, cam, cfg))
    got = np.asarray(megakernel.render_pallas(scene, cam, cfg,
                                                 interpret=True))
    np.testing.assert_array_equal(got, want)


def test_early_exit_equivalence():
    """depth larger than needed: the refill loop's early exit must not
    change pixels."""
    scene = raytpu.test_world()
    cfg_lo = RenderConfig(width=32, height=16, spp=2, depth=6)
    cfg_hi = RenderConfig(width=32, height=16, spp=2, depth=50)
    cam = _cam(cfg_lo)
    a = np.asarray(megakernel.render_pallas(scene, cam, cfg_lo,
                                            interpret=True))
    b = np.asarray(megakernel.render_pallas(scene, cam, cfg_hi,
                                            interpret=True))
    golden_hi = np.asarray(golden.render_golden(scene, cam, cfg_hi))
    np.testing.assert_array_equal(b, golden_hi)
    # depth-6 vs depth-50 differ only where paths actually run deep
    assert np.mean(np.abs(a - b) > 0) < 0.2


def test_custom_vjp_matches_golden_grad():
    """Backward (the adjoint VJP) == direct golden gradient."""
    cfg = RenderConfig(width=32, height=16, spp=1, depth=3)
    scene = raytpu.test_world()
    cam = _cam(cfg)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    def loss_pallas(s, c):
        img = megakernel.render_pallas(s, c, cfg, interpret=True)
        return jnp.mean((img - target) ** 2)

    def loss_golden(s, c):
        img = golden.render_golden(s, c, cfg)
        return jnp.mean((img - target) ** 2)

    (gps, gpc) = jax.grad(loss_pallas, argnums=(0, 1),
                          allow_int=True)(scene, cam)
    (ggs, ggc) = jax.grad(loss_golden, argnums=(0, 1),
                          allow_int=True)(scene, cam)
    pairs = ([(getattr(gps, k), getattr(ggs, k))
              for k in ("center", "radius", "albedo", "mat_param")]
             + list(zip(jax.tree.leaves(gpc), jax.tree.leaves(ggc))))
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-8)


def test_reference_v1_config_sqrt_gamma():
    """v1 preset: 1 spp, depth 25, sqrt gamma (gamma=2.0), thin lens —
    pallas == golden bitwise at reduced resolution."""
    from raytpu.config import REFERENCE_V1
    cfg = REFERENCE_V1.replace(width=64, height=48)
    scene = raytpu.test_world()
    cam = raytpu.reference_camera_v1()
    want = np.asarray(golden.render_golden(scene, cam, cfg))
    got = np.asarray(megakernel.render_pallas(scene, cam, cfg,
                                                 interpret=True))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(want).all()


def test_reference_v2_depth50():
    """Reference v2 depth (50) at tiny size: deep while-loop parity."""
    cfg = RenderConfig(width=32, height=16, spp=2, depth=50)
    scene = raytpu.test_world()
    cam = _cam(cfg)
    want = np.asarray(golden.render_golden(scene, cam, cfg))
    got = np.asarray(megakernel.render_pallas(scene, cam, cfg,
                                                 interpret=True))
    np.testing.assert_array_equal(got, want)
