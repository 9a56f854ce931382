"""The gradient rule: the engine's custom VJP is the XLA adjoint's VJP.

``jax.grad`` through the engine, ``render_grad`` on the engine and
``jax.grad`` of golden agree per leaf and per RNG mode; the adjoint's
scatter-add segment sum equals the one-hot product it replaced."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytpu
from raytpu import adjoint, golden
from raytpu.config import RenderConfig
from raytpu.kernels import megakernel

SCENE_LEAVES = ("center", "radius", "albedo", "mat_param")
CAM_LEAVES = ("origin", "horizontal", "vertical", "lower_left")


def _setup(rng_mode):
    cfg = RenderConfig(width=16, height=8, spp=2, depth=3, rng_mode=rng_mode)
    scene = raytpu.test_world()
    cam = raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                             aspect=cfg.aspect)
    target = jnp.full((cfg.height, cfg.width, 3), 0.25, jnp.float32)
    return cfg, scene, cam, target


@functools.lru_cache(maxsize=None)
def _grads(rng_mode, vis_w=0.0):
    """(engine jax.grad, render_grad on the engine, golden autodiff or
    the golden-backend adjoint when vis_w > 0), each (scene, cam)."""
    cfg, scene, cam, target = _setup(rng_mode)

    def loss_engine(s, c):
        img = megakernel.render_pallas(s, c, cfg, interpret=True,
                                       vis_w=vis_w)
        return jnp.mean((img - target) ** 2)

    def loss_golden(s, c):
        return jnp.mean((golden.render_golden(s, c, cfg) - target) ** 2)

    g_engine = jax.grad(loss_engine, argnums=(0, 1), allow_int=True)(
        scene, cam)
    _, _, g_rg = raytpu.render_grad(scene, cam, cfg, target,
                                    backend="pallas", interpret=True,
                                    vis_w=vis_w)
    if vis_w > 0:
        _, _, g_ref = raytpu.render_grad(scene, cam, cfg, target,
                                         backend="golden", vis_w=vis_w)
    else:
        g_ref = jax.grad(loss_golden, argnums=(0, 1), allow_int=True)(
            scene, cam)
    return g_engine, g_rg, g_ref


def _leaf(grads, leaf):
    s, c = grads
    return np.asarray(getattr(s, leaf) if leaf in SCENE_LEAVES
                      else getattr(c, leaf))


@pytest.mark.parametrize("leaf", SCENE_LEAVES + CAM_LEAVES)
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_engine_vjp_is_render_grad(rng_mode, leaf):
    """One forward (the engine), one backward (the adjoint): jax.grad
    through the engine and render_grad give the same numbers."""
    g_engine, g_rg, _ = _grads(rng_mode)
    np.testing.assert_allclose(_leaf(g_engine, leaf), _leaf(g_rg, leaf),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("leaf", SCENE_LEAVES + ("lower_left",))
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_engine_vjp_matches_golden_autodiff(rng_mode, leaf):
    """The adjoint reproduces jax.grad of golden; the tolerance is the
    two f32 estimators' shared accumulation noise."""
    g_engine, _, g_ref = _grads(rng_mode)
    want = _leaf(g_ref, leaf)
    scale = max(np.abs(want).max(), 1e-8)
    np.testing.assert_allclose(_leaf(g_engine, leaf), want,
                               atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_engine_camera_origin_grad(rng_mode):
    """d/d origin is a cancelling sum (per-ray origin terms minus the
    lower_left gradient); judged against the size of those terms."""
    g_engine, _, g_ref = _grads(rng_mode)
    scale = max(np.abs(_leaf(g_ref, "lower_left")).max(),
                np.abs(_leaf(g_ref, "origin")).max())
    err = np.abs(_leaf(g_engine, "origin") - _leaf(g_ref, "origin")).max()
    assert err <= 1e-4 * scale


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_engine_silhouette_grads(rng_mode):
    """vis_w > 0: the engine's VJP carries the adjoint's silhouette terms,
    equal to render_grad on either backend."""
    g_engine, g_rg, g_ref = _grads(rng_mode, vis_w=0.005)
    for leaf in ("center", "radius"):
        a = _leaf(g_engine, leaf)
        np.testing.assert_allclose(a, _leaf(g_rg, leaf), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(a, _leaf(g_ref, leaf), rtol=1e-5,
                                   atol=1e-8)


def _one_hot_sum(idx, vals, n):
    oh = jax.nn.one_hot(idx.reshape(-1), n, dtype=jnp.float32, axis=0)
    return jnp.matmul(oh, vals, precision="highest")


@pytest.mark.parametrize("n, shape, k", [
    (1, (7,), 3),
    (4, (16,), 8),
    (5, (4, 6), 4),       # idx keeps the ray batch's shape
    (500, (2048,), 8),
    (3, (10,), 1),
])
def test_segment_sum_matches_one_hot(n, shape, k):
    rng = np.random.default_rng(n * 31 + k)
    idx = jnp.asarray(rng.integers(0, n, size=shape), jnp.int32)
    vals = jnp.asarray(rng.standard_normal((idx.size, k)), jnp.float32)
    got = adjoint.segment_sum(idx, vals, n)
    assert got.shape == (n, k)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(_one_hot_sum(idx, vals, n)),
                               rtol=1e-5, atol=1e-5)


def test_segment_sum_untouched_spheres_are_zero():
    idx = jnp.asarray([2, 2, 0], jnp.int32)
    vals = jnp.ones((3, 2), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(adjoint.segment_sum(idx, vals, 4)),
        [[1, 1], [0, 0], [2, 2], [0, 0]])
