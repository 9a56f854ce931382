"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: forward primary samples per second ("rays/s": width * height *
spp per second, BASELINE.json's workload unit) on config 2 (test_world
at 400x200, 20 spp, depth 12).  Bounce rays are the work behind each
sample, not extra credit.

``extra`` carries the other rows, each a wall time (host clock around
``block_until_ready``, median of a few calls after a warm-up) and a
device time (``profiling.device_ms`` over a trace of one call):

  - config 2: engine and golden forward; fwd+bwd through ``render_grad``
    (engine forward, XLA adjoint backward) and ``jax.grad`` through
    ``render``;
  - config 4 (500 spheres, 800x400, depth 12) at 20 and 100 spp:
    engine and golden forward, ``render_grad``;
  - REFERENCE_V2 (1024x576, 60 spp, depth 50, the reference's own v2
    run): engine and golden forward;
  - config 5 (1920x1080, 500 spp, depth 12): engine forward;
  - a gradient sweep: ``render_grad`` against ``jax.grad`` of golden and
    against central finite differences on probe pixels.

Run on a GPU (``python bench.py``); without one it exits non-zero.  Every
result names the platform, the device kind and count, and the card's
name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import raytpu
from raytpu import golden
from raytpu.config import CONFIG2, CONFIG5, RenderConfig, REFERENCE_V2
from raytpu.profiling import device_ms
from raytpu.render import render, render_grad


def _cam(aspect: float):
    return raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=aspect)


def _row(extra, key, fn, args, rays, iters=3):
    """Wall and device time of ``fn(*args)`` -> ``{key}_ms``,
    ``{key}_rays_per_sec``, ``{key}_device_ms``, ``{key}_compile_s``.
    Returns the median wall in seconds."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    extra[f"{key}_compile_s"] = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    t = sorted(ts)[len(ts) // 2]
    extra[f"{key}_ms"] = t * 1e3
    extra[f"{key}_rays_per_sec"] = rays / t
    extra[f"{key}_device_ms"] = device_ms(
        lambda: jax.block_until_ready(fn(*args)))
    return t


def _fwd(cfg, backend):
    return jax.jit(lambda s, c: render(s, c, cfg, backend=backend))


def _render_grad(cfg, target):
    return jax.jit(lambda s, c: render_grad(s, c, cfg, target))


def _grad_through_render(cfg, target):
    def loss(s, c):
        return jnp.mean((render(s, c, cfg) - target) ** 2)
    return jax.jit(jax.grad(loss, argnums=(0, 1), allow_int=True))


def bench_config2(extra):
    cfg = CONFIG2
    scene, cam = raytpu.config2_world(), _cam(cfg.aspect)
    rays = cfg.width * cfg.height * cfg.spp
    t = _row(extra, "config2_fwd", _fwd(cfg, "pallas"), (scene, cam), rays,
             iters=10)
    _row(extra, "config2_fwd_golden", _fwd(cfg, "golden"), (scene, cam),
         rays)
    target = golden.render_golden(scene, cam, cfg)
    _row(extra, "config2_render_grad", _render_grad(cfg, target),
         (scene, cam), rays)
    _row(extra, "config2_grad_through_render",
         _grad_through_render(cfg, target), (scene, cam), rays)
    return rays / t


def bench_config4(extra):
    scene = raytpu.final_world()
    for spp in (20, 100):
        cfg = RenderConfig(width=800, height=400, spp=spp, depth=12)
        cam = _cam(cfg.aspect)
        rays = cfg.width * cfg.height * cfg.spp
        key = f"config4_{spp}spp"
        _row(extra, f"{key}_fwd", _fwd(cfg, "pallas"), (scene, cam), rays)
        _row(extra, f"{key}_fwd_golden", _fwd(cfg, "golden"), (scene, cam),
             rays, iters=1)
        target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
        _row(extra, f"{key}_render_grad", _render_grad(cfg, target),
             (scene, cam), rays, iters=1)


def bench_refv2(extra):
    cfg = REFERENCE_V2
    scene, cam = raytpu.random_world(), raytpu.reference_camera_v2()
    rays = cfg.width * cfg.height * cfg.spp
    _row(extra, "refv2_fwd", _fwd(cfg, "pallas"), (scene, cam), rays)
    _row(extra, "refv2_fwd_golden", _fwd(cfg, "golden"), (scene, cam),
         rays, iters=1)


def bench_config5(extra):
    cfg = CONFIG5
    scene, cam = raytpu.final_world(), _cam(cfg.aspect)
    rays = cfg.width * cfg.height * cfg.spp
    _row(extra, "config5_fwd", _fwd(cfg, "pallas"), (scene, cam), rays,
         iters=1)


def bench_grad_sweep(extra):
    """``render_grad`` (engine forward, adjoint backward) against
    ``jax.grad`` of golden for every parameter kind, and against central
    finite differences where the probe loss is smooth.  IOR (Schlick
    branch flips under any epsilon) and the camera origin (secondary
    silhouettes) are discontinuous, so for those autodiff is the check.
    The cotangent is one-hot on probe pixels whose primary hit lies well
    inside the sphere."""
    from raytpu.camera import get_ray

    cfg = RenderConfig(width=128, height=64, spp=4, depth=6)
    scene, cam = raytpu.config2_world(), _cam(cfg.aspect)
    ys, xs = np.mgrid[0:cfg.height, 0:cfg.width]
    u = (xs + 0.55) / (cfg.width - 1)
    v = (ys + 0.55) / (cfg.height - 1)
    ro, rd, _ = get_ray(cam, jnp.asarray(u, jnp.float32),
                        jnp.asarray(v, jnp.float32),
                        jnp.zeros(u.shape, jnp.uint32))
    hit_any, _, idx, _, _ = golden.hit_world(scene, ro, rd, cfg.t_min)
    idx = np.where(np.asarray(hit_any), np.asarray(idx), -1)

    def probe_ct(sphere):
        m = idx == sphere
        inner = m.copy()
        for s_ in (1, -1):
            inner &= np.roll(m, s_ * 2, 0) & np.roll(m, s_ * 2, 1)
        py, px = np.nonzero(inner)
        k = max(1, len(py) // 4)
        ct = np.zeros((cfg.height, cfg.width, 3), np.float32)
        ct[py[::k][:4], px[::k][:4]] = 1.0
        return jnp.asarray(ct)

    # render_grad's loss is mean((img - target)^2); target = img - ct *
    # numel / 2 makes its cotangent exactly ct
    @jax.jit
    def adjoint_grads(scene, cam, ct):
        img = render(scene, cam, cfg)
        target = jax.lax.stop_gradient(img) - ct * (ct.size / 2.0)
        _, _, g = render_grad(scene, cam, cfg, target)
        return g

    @jax.jit
    def autodiff_grads(scene, cam, ct):
        def loss(s, c):
            return jnp.sum(golden.render_golden(s, c, cfg) * ct)
        with jax.default_matmul_precision("highest"):
            return jax.grad(loss, argnums=(0, 1), allow_int=True)(scene, cam)

    @jax.jit
    def probe_sum(scene, cam, ct):
        return jnp.sum(golden.render_golden(scene, cam, cfg) * ct)

    def fd(ct, up_s, up_c, eps=2e-3):
        if up_s is not None:
            return (float(probe_sum(up_s(eps), cam, ct))
                    - float(probe_sum(up_s(-eps), cam, ct))) / (2 * eps)
        return (float(probe_sum(scene, up_c(eps), ct))
                - float(probe_sum(scene, up_c(-eps), ct))) / (2 * eps)

    fuzzed = scene._replace(mat_param=scene.mat_param.at[2].add(0.2))
    cases = [
        ("center_y", 1, scene, lambda e: scene._replace(
            center=scene.center.at[1, 1].add(e)), None,
         lambda ds, dc: ds.center[1, 1]),
        ("radius", 1, scene, lambda e: scene._replace(
            radius=scene.radius.at[1].add(e)), None,
         lambda ds, dc: ds.radius[1]),
        ("albedo_r", 1, scene, lambda e: scene._replace(
            albedo=scene.albedo.at[1, 0].add(e)), None,
         lambda ds, dc: ds.albedo[1, 0]),
        # fuzz 0 is a clamp boundary: gradients at fuzz 0.2
        ("fuzz", 2, fuzzed, lambda e: fuzzed._replace(
            mat_param=fuzzed.mat_param.at[2].add(e)), None,
         lambda ds, dc: ds.mat_param[2]),
        ("ior", 3, scene, None, None, lambda ds, dc: ds.mat_param[3]),
        ("cam_origin_x", 1, scene, None, None,
         lambda ds, dc: dc.origin[0]),
    ]
    ad_errs, fd_errs = {}, {}
    for name, sphere, base, up_s, up_c, pick in cases:
        ct = probe_ct(sphere)
        an = float(pick(*adjoint_grads(base, cam, ct)))
        ad = float(pick(*autodiff_grads(base, cam, ct)))
        ad_errs[name] = abs(an - ad) / max(abs(ad), 1e-5)
        if up_s is not None or up_c is not None:
            num = fd(ct, up_s, up_c)
            fd_errs[name] = abs(an - num) / max(abs(num), 1e-5)
    extra["render_grad_vs_autodiff_rel_err"] = ad_errs
    extra["render_grad_vs_fd_rel_err"] = fd_errs


def card() -> str:
    """Name and power limit, from ``nvidia-smi`` in a child process."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def main() -> int:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{devs[0].platform!r}")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    extra = {"card": card()}
    print(extra["card"], file=sys.stderr, flush=True)
    fwd_rays_s = bench_config2(extra)
    for section in (bench_config4, bench_refv2, bench_config5,
                    bench_grad_sweep):
        section(extra)
    print(json.dumps({
        "metric": "fwd_rays_per_sec_per_chip",
        "value": fwd_rays_s,
        "unit": "rays/s",
        "device": device,
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
