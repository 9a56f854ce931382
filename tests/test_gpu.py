"""The compiled engine on the card.  Skips without a GPU; run with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu

Compiled, the engine's f32 evaluation order differs from XLA's in the
last bits (FMA contraction), so past the first bounce a few paths take
the other branch: images are compared within chip_smoke.py's bounds.
Paths that run the same compiled kernel (batches, slabs) stay bitwise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytpu
from raytpu import golden, progressive, shard
from raytpu.config import RenderConfig
from raytpu.kernels import megakernel

pytestmark = pytest.mark.gpu

CFG = RenderConfig(width=64, height=32, spp=4, depth=4)


def _cam(cfg):
    return raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=cfg.aspect)


def _stats(img, ref):
    d = np.abs(np.asarray(img) - np.asarray(ref))
    return (d > 3e-4).mean(), d.mean()


def test_compiled_engine_depth1_matches_golden(gpu_device):
    cfg = CFG.replace(depth=1)
    scene = raytpu.random_world(seed=3, half_extent=3)
    with jax.default_device(gpu_device):
        img = megakernel.render_pallas(scene, _cam(cfg), cfg)
        ref = golden.render_golden(scene, _cam(cfg), cfg)
    frac, mean = _stats(img, ref)
    assert frac <= 1e-3 and mean <= 1e-4


def test_compiled_engine_matches_golden(gpu_device):
    scene = raytpu.test_world()
    with jax.default_device(gpu_device):
        img = megakernel.render_pallas(scene, _cam(CFG), CFG)
        ref = golden.render_golden(scene, _cam(CFG), CFG)
    assert np.isfinite(np.asarray(img)).all()
    frac, mean = _stats(img, ref)
    assert frac <= 0.05 and mean <= 5e-4


@pytest.mark.parametrize("block", [16, 64, 128])
def test_compiled_engine_block_invariant(gpu_device, block):
    scene = raytpu.test_world()
    with jax.default_device(gpu_device):
        a = megakernel.render_pallas(scene, _cam(CFG), CFG)
        b = megakernel.render_pallas(scene, _cam(CFG), CFG, block=block)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_compiled_progressive_batches_bit_equal(gpu_device):
    cfg = CFG.replace(rng_mode="parallel")
    scene = raytpu.test_world()
    with jax.default_device(gpu_device):
        one = progressive.accumulate(scene, _cam(cfg), cfg,
                                     progressive.init_state(cfg), 4,
                                     backend="pallas")
        two = progressive.init_state(cfg)
        for _ in range(2):
            two = progressive.accumulate(scene, _cam(cfg), cfg, two, 2,
                                         backend="pallas")
    np.testing.assert_array_equal(np.asarray(one.acc), np.asarray(two.acc))


def test_compiled_slab_render_equals_frame(gpu_device):
    scene = raytpu.test_world()
    mesh = shard.make_mesh([gpu_device])
    with jax.default_device(gpu_device):
        frame = megakernel.render_pallas(scene, _cam(CFG), CFG)
        slab = shard.render_sharded_pallas(scene, _cam(CFG), CFG, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(frame), np.asarray(slab))


def test_compiled_grad_through_render_is_render_grad(gpu_device):
    scene = raytpu.test_world()
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)

    def loss(s, c):
        return jnp.mean((raytpu.render(s, c, CFG) - target) ** 2)

    with jax.default_device(gpu_device):
        _, _, (gs, _) = raytpu.render_grad(scene, _cam(CFG), CFG, target)
        ts, _ = jax.grad(loss, argnums=(0, 1), allow_int=True)(
            scene, _cam(CFG))
    for k in ("center", "radius", "albedo", "mat_param"):
        a, b = np.asarray(getattr(ts, k)), np.asarray(getattr(gs, k))
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
