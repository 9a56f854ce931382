"""Silhouette-gradient estimator benchmark (round-3 verdict item 7).

Config-3-style inverse rendering (defocus camera, recover a perturbed
sphere center from a target image) with the loss+gradient through
``render_grad`` (the adjoint's VJP), sweeping the silhouette weight:

  vis_w = 0        interior gradients only (no visibility term)
  vis_w = 0.005    the shipped one-bounce boundary-radiance estimate

Reports, per setting: steps to reach loss thresholds (50% / 10% / 5%
of the initial loss) and the final center error, over a grid of
perturbation sizes.  The question the table answers: does the
one-bounce radiance estimate's bias (the boundary terms weight the
coverage flip by an approximate radiance jump) actually slow
convergence enough to justify a path-traced boundary estimate?

Run:  python -m scripts.bench_silhouette          (default device)
      python -m scripts.bench_silhouette cpu      (on the CPU)

MEASURED (80 steps, lr 0.05 x 0.96^step; the same adjoint math through
an earlier gradient kernel):

  shift   vis_w   steps_to_50%  final_loss/initial  center_err ->
  0.144   0       never         6.0 (DIVERGES)      1.20
  0.144   0.005   2             0.24                0.040
  0.292   0       never         2.6 (DIVERGES)      1.24
  0.292   0.005   3             0.11                0.039
  0.058   0       never         16.0 (DIVERGES)     0.044
  0.058   0.005   1             0.56                0.044

  plateau discriminator (80 more steps with the lr schedule restarted):
  vis_w=0.002: 0.0355 -> 0.0063   (plateau was the LR SCHEDULE)
  vis_w=0.005: 0.0396 -> 0.0393   (vis_w-width bias floor ~0.04)
  vis_w=0.02:  0.0535 -> 0.0559   (wider sigmoid = more bias)

CONCLUSION (round-2 verdict item 7): without the silhouette terms,
config-3 geometry recovery DIVERGES at every tested perturbation — the
interior gradient's visibility blindness is fatal, not just slow.  With
them it converges in 1-3 steps to half-loss; the residual center-error
floor scales with vis_w (the soft-coverage sigmoid width), NOT with the
one-bounce radiance-jump approximation: at vis_w = 0.002 the error
reaches 6e-3 (1.2% of the sphere radius).  A path-traced boundary
-radiance estimate is therefore NOT the binding fidelity lever —
annealing vis_w is.  The cheap estimator stays.
"""
from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np


def load_example():
    spec = importlib.util.spec_from_file_location(
        "inverse_render",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", "inverse_render.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def steps_to(losses, frac):
    l0 = losses[0]
    for i, l in enumerate(losses):
        if l <= frac * l0:
            return i
    return None


def main():
    import jax
    if len(sys.argv) > 1 and sys.argv[1] == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    m = load_example()
    print("platform", jax.devices()[0].platform, flush=True)

    steps = 80
    rows = []
    for shift in ((0.12, 0.0, 0.08), (0.25, 0.0, 0.15),
                  (0.05, 0.0, 0.03)):
        cfg, scene_true, scene0, cam, target = m.make_problem(shift=shift)
        err0 = float(jnp.linalg.norm(
            scene0.center[1] - scene_true.center[1]))
        for vis_w in (0.0, 0.005):
            scene, losses = m.optimize(cfg, scene0, cam, target,
                                       steps=steps, vis_w=vis_w)
            err1 = float(jnp.linalg.norm(
                scene.center[1] - scene_true.center[1]))
            rows.append((err0, vis_w,
                         steps_to(losses, 0.5), steps_to(losses, 0.1),
                         steps_to(losses, 0.05),
                         losses[-1] / losses[0], err1))
            print(f"shift={err0:.3f} vis_w={vis_w}: "
                  f"steps_to_50%={rows[-1][2]} 10%={rows[-1][3]} "
                  f"5%={rows[-1][4]} final_loss_frac="
                  f"{rows[-1][5]:.3f} center_err {err0:.3f}->"
                  f"{err1:.4f}", flush=True)

    # plateau discriminator: is the ~0.04 center-error floor estimator
    # BIAS (restarting the lr schedule would not help) or the schedule
    # (lr decays 0.96^steps; a restart resumes progress)?  Plus a
    # vis_w sensitivity check.
    cfg, scene_true, scene0, cam, target = m.make_problem(
        shift=(0.12, 0.0, 0.08))
    for vis_w in (0.002, 0.005, 0.02):
        scene, l1 = m.optimize(cfg, scene0, cam, target, steps=steps,
                               vis_w=vis_w)
        e1 = float(jnp.linalg.norm(scene.center[1]
                                   - scene_true.center[1]))
        scene, l2 = m.optimize(cfg, scene, cam, target, steps=steps,
                               vis_w=vis_w)
        e2 = float(jnp.linalg.norm(scene.center[1]
                                   - scene_true.center[1]))
        print(f"restart vis_w={vis_w}: err after 80={e1:.4f} "
              f"after 160 (lr restarted)={e2:.4f} "
              f"loss {l1[-1]:.3e}->{l2[-1]:.3e}", flush=True)


if __name__ == "__main__":
    main()
