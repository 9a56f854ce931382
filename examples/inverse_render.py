"""BASELINE config 3: defocus-blur camera + gradient descent on sphere
positions to match a target image.

Perturbs the hero sphere's position, then recovers it by minimizing MSE
against the target render.  Gradients (including the vis_w silhouette
boundary terms) flow through the hand-structured XLA adjoint
(raytpu/adjoint.py) behind `render_grad(..., vis_w=...)`; on a GPU the
forward is the Pallas engine.  Run:

    python examples/inverse_render.py [--steps 60] [--out-dir /tmp] \
        [--size 400x200] [--checkpoint opt.npz]

Writes target.png / initial.png / recovered.png and prints the loss
trajectory; --checkpoint enables bit-exact Adam resume (raytpu/optim.py).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import jax
import jax.numpy as jnp

import raytpu
from raytpu import io
from raytpu.config import RenderConfig


def make_problem(shift=(0.12, 0.0, 0.08), size=(96, 48)):
    cfg = RenderConfig(width=size[0], height=size[1], spp=4, depth=4)
    scene_true = raytpu.make_scene([
        ((0.0, -100.5, -1.0), 100.0, 0, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 0.0, -1.0), 0.5, 0, (0.7, 0.3, 0.3), 0.0),
    ])
    # defocus camera (BASELINE config 3's distinguishing feature)
    cam = raytpu.make_camera((0.0, 0.3, 1.5), (0.0, 0.0, -1.0), vfov=45.0,
                             aspect=cfg.aspect, aperture=0.25,
                             focus_dist=2.5)
    target = raytpu.render(scene_true, cam, cfg)
    scene0 = scene_true._replace(
        center=scene_true.center.at[1].add(jnp.asarray(shift)))
    return cfg, scene_true, scene0, cam, target


def optimize(cfg, scene, cam, target, steps=120, lr=0.05, vis_w=0.005,
             checkpoint=None):
    """Normalized gradient descent on sphere centers; silhouette
    gradients (vis_w) supply the visibility term that pure interior
    gradients lack.  Each step is one jitted render_grad: the engine's
    forward (a GPU; golden on the CPU) and the XLA adjoint's backward."""
    from raytpu.render import render_grad

    @jax.jit
    def step(scene, lr):
        s_loss, _, (sg, _) = render_grad(scene, cam, cfg, target,
                                         vis_w=vis_w)
        g = sg.center
        gn = g / (jnp.linalg.norm(g) + 1e-12)
        return scene._replace(center=scene.center - lr * gn), s_loss

    losses = []
    for i in range(steps):
        scene, loss = step(scene, lr)
        losses.append(float(loss))
        lr *= 0.96
        if checkpoint and (i + 1) % 20 == 0:
            from raytpu.optim import save_opt_checkpoint
            save_opt_checkpoint(checkpoint, scene.center, (), i + 1)
    return scene, losses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--size", default="96x48",
                   help="WxH; 400x200 is BASELINE config 3's size")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--final-scene", action="store_true",
                   help="recover positions in the 500-sphere final "
                        "scene")
    args = p.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))

    if args.final_scene:
        import jax.numpy as _jnp
        from raytpu.config import RenderConfig
        cfg = RenderConfig(width=w, height=h, spp=4, depth=4,
                           rng_mode="parallel")
        scene_true = raytpu.final_world()
        cam = raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                                 vfov=20.0, aspect=cfg.aspect)
        target = raytpu.render(scene_true, cam, cfg)
        scene0 = scene_true._replace(
            center=scene_true.center + _jnp.float32(0.05))
    else:
        cfg, scene_true, scene0, cam, target = make_problem(size=(w, h))
    io.save_png(os.path.join(args.out_dir, "target.png"), target)
    io.save_png(os.path.join(args.out_dir, "initial.png"),
                raytpu.render(scene0, cam, cfg))

    err0 = float(jnp.linalg.norm(scene0.center[1] - scene_true.center[1]))
    scene, losses = optimize(cfg, scene0, cam, target, steps=args.steps,
                             checkpoint=args.checkpoint)
    err1 = float(jnp.linalg.norm(scene.center[1] - scene_true.center[1]))

    io.save_png(os.path.join(args.out_dir, "recovered.png"),
                raytpu.render(scene, cam, cfg))
    print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e}   "
          f"position error {err0:.4f} -> {err1:.4f}")
    return 0 if (losses[-1] < 0.3 * losses[0] and err1 < 0.5 * err0) else 1


if __name__ == "__main__":
    sys.exit(main())
