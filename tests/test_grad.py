"""Gradient correctness: analytic (jax.jvp/grad of the golden renderer) vs
central finite differences — the BASELINE.json north-star metric.

The reference has no gradients at all; this is new capability.  The
discrete-event policy (SURVEY.md §7 hard-part 1): closest-hit selection,
front-face sign, TIR and the Schlick coin flip are detached, so the analytic
gradient is the *interior* (shading) derivative.  Finite differences measure
the full derivative including visibility/silhouette terms, which are delta
distributions on the silhouette set.  Therefore FD checks are done
**per-pixel at interior pixels** (away from silhouettes) where the two
notions coincide; a majority vote absorbs the rare sample whose jittered
sub-ray grazes a boundary or whose detached Schlick coin flips under eps.

Each check: analytic d(pixel)/d(theta) from one jax.jvp pass; FD from two
renders at theta +- eps; require >= 3/4 of probe pixels to agree within a
relative tolerance.  f32 FD noise floor ~ 1e-7/eps per pixel.
"""

import numpy as np
import jax
import jax.numpy as jnp

import raytpu
from raytpu import golden
from raytpu.config import RenderConfig
from raytpu.render import render_grad


CFG = RenderConfig(width=48, height=24, spp=2, depth=4)

# interior probe pixels: the hero sphere at (0,0,-1) r=0.5 seen from
# (0,0.3,1.5) vfov 45 covers roughly x in [16,32], y in [6,18] of 48x24.
PROBES = [(22, 12), (24, 12), (26, 13), (23, 11), (25, 14), (24, 10),
          (21, 13), (27, 12)]


def _hero_scene(mat_type, mat_param, albedo=(0.7, 0.3, 0.3)):
    """Ground + one centered hero sphere (isolated: no other silhouettes
    for bounce rays to graze)."""
    return raytpu.make_scene([
        ((0.0, -100.5, -1.0), 100.0, 0, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 0.0, -1.0), 0.5, mat_type, albedo, mat_param),
    ])


def _cam(aperture=0.0):
    return raytpu.make_camera((0.0, 0.3, 1.5), (0.0, 0.0, -1.0), vfov=45.0,
                              aspect=CFG.aspect, aperture=aperture,
                              focus_dist=2.5)


def _pixels_fn(cfg=CFG, probes=PROBES):
    px = jnp.array([p[0] for p in probes], jnp.int32)
    py = jnp.array([p[1] for p in probes], jnp.int32)

    def f(scene, cam):
        r, g, b = golden.render_pixels(scene, cam, cfg, px, py)
        return r + g + b  # (P,) pixel luminance

    return jax.jit(f)


def _check_jvp_vs_fd(apply, theta0, eps, rel=0.2, floor=3e-3, min_agree=6):
    """apply: scalar theta -> (P,) pixel values. Compares one jvp pass
    against central FD; requires >= min_agree probes within tolerance."""
    analytic = jax.jvp(apply, (jnp.float32(theta0),), (jnp.float32(1.0),))[1]
    fd = (apply(jnp.float32(theta0 + eps))
          - apply(jnp.float32(theta0 - eps))) / (2.0 * eps)
    analytic = np.asarray(analytic, np.float64)
    fd = np.asarray(fd, np.float64)
    scale = np.maximum(np.maximum(np.abs(analytic), np.abs(fd)), floor)
    ok = np.abs(analytic - fd) <= rel * scale
    assert ok.sum() >= min_agree, (
        f"only {ok.sum()}/{ok.size} probes agree\n"
        f"analytic={analytic}\nfd={fd}")


def test_grad_albedo_matches_fd():
    scene0, cam = _hero_scene(0, 0.0), _cam()
    pix = _pixels_fn()

    def apply(a):
        return pix(scene0._replace(albedo=scene0.albedo.at[1, 0].set(a)), cam)

    _check_jvp_vs_fd(apply, 0.7, eps=1e-2, rel=0.05, min_agree=8)


def test_grad_center_matches_fd():
    scene0, cam = _hero_scene(0, 0.0), _cam()
    pix = _pixels_fn()

    def apply(cy):
        return pix(scene0._replace(
            center=scene0.center.at[1, 1].set(cy)), cam)

    _check_jvp_vs_fd(apply, 0.0, eps=1e-3)


def test_grad_radius_matches_fd():
    scene0, cam = _hero_scene(0, 0.0), _cam()
    pix = _pixels_fn()

    def apply(r):
        return pix(scene0._replace(radius=scene0.radius.at[1].set(r)), cam)

    _check_jvp_vs_fd(apply, 0.5, eps=1e-3)


def test_grad_fuzz_matches_fd():
    scene0, cam = _hero_scene(1, 0.3, albedo=(0.8, 0.7, 0.6)), _cam()
    pix = _pixels_fn()

    def apply(fz):
        return pix(scene0._replace(
            mat_param=scene0.mat_param.at[1].set(fz)), cam)

    _check_jvp_vs_fd(apply, 0.3, eps=2e-3, rel=0.3)


def test_grad_ior_matches_fd():
    """IOR flows through the refraction direction and Schlick value (the
    coin flip itself is detached — probes where the flip crosses under eps
    disagree, hence the majority vote)."""
    scene0, cam = _hero_scene(2, 1.5, albedo=(1.0, 1.0, 1.0)), _cam()
    pix = _pixels_fn()

    def apply(ior):
        return pix(scene0._replace(
            mat_param=scene0.mat_param.at[1].set(ior)), cam)

    _check_jvp_vs_fd(apply, 1.5, eps=2e-3, rel=0.35, min_agree=5)


def test_grad_camera_matches_fd():
    """Camera-pose gradients flow through make_camera into the basis."""
    scene = _hero_scene(0, 0.0)
    pix = _pixels_fn()

    def apply(from_y):
        cam = raytpu.make_camera(
            jnp.stack([jnp.float32(0.0), from_y, jnp.float32(1.5)]),
            (0.0, 0.0, -1.0), vfov=45.0, aspect=CFG.aspect)
        return pix(scene, cam)

    _check_jvp_vs_fd(apply, 0.3, eps=1e-3)


def test_grad_defocus_camera_matches_fd():
    """Thin-lens path: gradients also flow through the lens offset."""
    scene = _hero_scene(0, 0.0)
    pix = _pixels_fn()
    cam0 = _cam(aperture=0.3)

    def apply(lr):
        return pix(scene, cam0._replace(lens_radius=lr))

    _check_jvp_vs_fd(apply, float(cam0.lens_radius), eps=2e-3, rel=0.3)


def test_render_grad_api():
    """render_grad returns finite grads for every continuous leaf."""
    scene, cam = _hero_scene(0, 0.0), _cam(aperture=0.2)
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    loss, img, (gs, gc) = render_grad(scene, cam, CFG, target,
                                      backend="golden")
    assert np.isfinite(float(loss))
    assert img.shape == (CFG.height, CFG.width, 3)
    for leaf in [gs.center, gs.radius, gs.albedo, gs.mat_param,
                 gc.origin, gc.horizontal, gc.vertical, gc.lower_left,
                 gc.lens_radius]:
        assert np.isfinite(np.asarray(leaf)).all()
    assert float(jnp.abs(gs.center).max()) > 0  # geometry grads are live


def test_gradient_descent_recovers_albedo():
    """Micro inverse-rendering: recover a perturbed albedo by gradient
    descent (BASELINE config 3's optimization loop, scaled down)."""
    cfg = RenderConfig(width=32, height=16, spp=2, depth=3)
    scene_true = _hero_scene(0, 0.0)
    cam = _cam()
    target = golden.render_golden(scene_true, cam, cfg)

    scene = scene_true._replace(
        albedo=scene_true.albedo.at[1].set(jnp.array([0.3, 0.6, 0.5])))

    @jax.jit
    def step(scene_, lr):
        def loss_fn(s):
            img = golden.render_golden(s, cam, cfg)
            return jnp.mean((img - target) ** 2)
        loss, g = jax.value_and_grad(loss_fn, allow_int=True)(scene_)
        # normalized step on albedo only (simple, scale-free)
        gn = g.albedo / (jnp.linalg.norm(g.albedo) + 1e-12)
        new_alb = jnp.clip(scene_.albedo - lr * gn, 0.0, 1.0)
        return scene_._replace(albedo=new_alb), loss

    losses = []
    lr = 0.1
    for i in range(25):
        scene, loss = step(scene, lr)
        losses.append(float(loss))
        lr *= 0.9
    assert losses[-1] < 0.2 * losses[0], losses
    err = float(jnp.abs(scene.albedo[1] - scene_true.albedo[1]).max())
    assert err < 0.15, err
