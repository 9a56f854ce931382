"""Sharding: pixel-tile shard_map over a virtual 8-device CPU mesh.

Validates the SURVEY.md §7 hard-part-3 invariant (renders are bit-identical
across mesh sizes because RNG keys derive from absolute pixel coords) and
that the psum'd gradient train step reduces loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytpu
from raytpu import golden, shard
from raytpu.config import RenderConfig


CFG = RenderConfig(width=40, height=24, spp=2, depth=3, chunk_pixels=64)


def _scene_cam():
    scene = raytpu.test_world()
    cam = raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                             aspect=CFG.aspect)
    return scene, cam


def test_eight_devices_available():
    assert jax.device_count() >= 8, (
        "conftest should force an 8-device CPU mesh")


def test_sharded_matches_single_device():
    scene, cam = _scene_cam()
    want = np.asarray(golden.render_golden(scene, cam, CFG))

    mesh = shard.make_mesh(jax.devices()[:8])
    got = np.asarray(shard.render_sharded(scene, cam, CFG, mesh=mesh))
    np.testing.assert_array_equal(got, want)


def test_sharded_matches_across_mesh_sizes():
    scene, cam = _scene_cam()
    imgs = []
    for nd in (1, 2, 4, 8):
        mesh = shard.make_mesh(jax.devices()[:nd])
        imgs.append(np.asarray(
            shard.render_sharded(scene, cam, CFG, mesh=mesh)))
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])


def test_train_step_reduces_loss():
    """Albedo-only perturbation on a smooth hero scene: the psum'd SGD step
    must recover most of the loss (geometry/camera noise terms are tiny
    here, so the trajectory is decisively downhill)."""
    cfg = RenderConfig(width=32, height=16, spp=2, depth=3, chunk_pixels=64)
    scene_true = raytpu.make_scene([
        ((0.0, -100.5, -1.0), 100.0, 0, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 0.0, -1.0), 0.5, 0, (0.7, 0.3, 0.3), 0.0),
    ])
    cam = raytpu.make_camera((0.0, 0.3, 1.5), (0.0, 0.0, -1.0), vfov=45.0,
                             aspect=cfg.aspect)
    target = golden.render_golden(scene_true, cam, cfg)

    scene = scene_true._replace(
        albedo=scene_true.albedo.at[1].set(jnp.array([0.3, 0.6, 0.5])))
    mesh = shard.make_mesh(jax.devices()[:8])
    step = shard.make_train_step(cfg, mesh, lr=2.0)

    losses = []
    for _ in range(20):
        scene, cam, loss = step(scene, cam, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], losses


def test_train_step_grads_match_unsharded():
    """psum'd sharded gradient == single-device jax.grad of the same loss."""
    cfg = RenderConfig(width=16, height=8, spp=1, depth=2, chunk_pixels=32)
    scene, cam = _scene_cam()
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    def loss_fn(scene, cam):
        img = golden.render_golden(scene, cam, cfg)
        return jnp.mean((img - target) ** 2)

    g_ref = jax.grad(loss_fn, argnums=0, allow_int=True)(scene, cam)

    mesh = shard.make_mesh(jax.devices()[:8])
    step = shard.make_train_step(cfg, mesh, lr=1.0)
    scene2, _, _ = step(scene, cam, target)
    # recovered gradient = (scene - scene2) / lr
    for name in ("center", "radius", "albedo", "mat_param"):
        want = np.asarray(getattr(g_ref, name))
        got = np.asarray(getattr(scene, name)) - np.asarray(
            getattr(scene2, name))
        # atol: psum's shard-wise f32 summation order differs from the
        # single-device full-image reduction
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-5)


def test_sharded_pallas_matches_golden_across_mesh_sizes():
    """Row-slab engine sharding (traced row0 operand) is bit-identical to
    golden for every mesh size."""
    cfg = RenderConfig(width=40, height=24, spp=2, depth=3)
    scene, cam = _scene_cam()
    want = np.asarray(golden.render_golden(scene, cam, cfg))
    for nd in (1, 2, 8):
        mesh = shard.make_mesh(jax.devices()[:nd])
        got = np.asarray(
            shard.render_sharded_pallas(scene, cam, cfg, mesh=mesh,
                                        interpret=True))
        np.testing.assert_array_equal(got, want)


def test_pallas_train_step_matches_reference_grads():
    """Sharded engine train step: psum'd adjoint gradients match
    single-device autodiff of the golden renderer."""
    cfg = RenderConfig(width=32, height=16, spp=1, depth=2)
    scene_true, cam = _scene_cam()
    cfg = RenderConfig(width=32, height=16, spp=1, depth=2)
    target = golden.render_golden(scene_true, cam, cfg)
    scene = scene_true._replace(
        albedo=scene_true.albedo.at[1].set(jnp.array([0.3, 0.6, 0.5])))

    mesh = shard.make_mesh(jax.devices()[:2])
    step = shard.make_train_step_pallas(cfg, mesh, lr=1.0,
                                       interpret=True)
    s2, c2, loss = step(scene, cam, target)
    assert np.isfinite(float(loss))

    def loss_fn(s, c):
        img = golden.render_golden(s, c, cfg)
        return jnp.mean((img - target) ** 2)

    g_ref = jax.grad(loss_fn, argnums=0, allow_int=True)(scene, cam)
    for k in ("center", "radius", "albedo", "mat_param"):
        got = np.asarray(getattr(scene, k)) - np.asarray(getattr(s2, k))
        want = np.asarray(getattr(g_ref, k))
        # floor absorbs f32 noise on near-zero gradient components
        scale = max(np.abs(want).max(), 1e-5)
        assert np.abs(got - want).max() / scale < 5e-3, k


def test_pallas_train_step_parallel_rng_elision():
    """Parallel-RNG sharded train step: per-sample streams with
    row0-offset pixel seeds in both the engine slab and the adjoint slab
    — the psum'd gradients must match single-device autodiff of the
    golden renderer in the same RNG mode."""
    cfg = RenderConfig(width=32, height=16, spp=2, depth=2,
                       rng_mode="parallel")
    scene_true, cam = _scene_cam()
    target = golden.render_golden(scene_true, cam, cfg)
    scene = scene_true._replace(
        albedo=scene_true.albedo.at[1].set(jnp.array([0.3, 0.6, 0.5])))

    mesh = shard.make_mesh(jax.devices()[:4])
    step = shard.make_train_step_pallas(cfg, mesh, lr=1.0,
                                       interpret=True)
    s2, c2, loss = step(scene, cam, target)
    assert np.isfinite(float(loss))

    def loss_fn(s, c):
        img = golden.render_golden(s, c, cfg)
        return jnp.mean((img - target) ** 2)

    g_ref = jax.grad(loss_fn, argnums=0, allow_int=True)(scene, cam)
    for k in ("center", "radius", "albedo", "mat_param"):
        got = np.asarray(getattr(scene, k)) - np.asarray(getattr(s2, k))
        want = np.asarray(getattr(g_ref, k))
        scale = max(np.abs(want).max(), 1e-5)
        assert np.abs(got - want).max() / scale < 5e-3, k
