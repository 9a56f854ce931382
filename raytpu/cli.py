"""Command-line interface — the framework's L3 shell.

Replaces the reference's Win32 entry points (CSVersion/main.cpp:16-139,
main.cpp:18-133: create a window, render once, pump messages) with a
headless CLI:

    python -m raytpu.cli render --scene random --width 1024 --height 576 \
        --spp 60 --depth 50 --out frame.png
    python -m raytpu.cli render --scene final --progressive 16 \
        --checkpoint ckpt.npz --resume --out final.png
    python -m raytpu.cli gradcheck
    python -m raytpu.cli info

Every knob the reference hardcodes (SURVEY.md §5 config table) is a flag.
"""

from __future__ import annotations

import argparse
import json
import sys


SCENES = ("config1", "test", "random", "final", "v1")


def _build_scene(name: str, seed: int, scene_file=None):
    import raytpu
    if scene_file:
        from raytpu.scene_io import load_scene
        return load_scene(scene_file)
    if name == "config1":
        return raytpu.config1_world()
    if name == "test":
        return raytpu.test_world()
    if name == "random":
        return raytpu.random_world(seed=seed)
    if name == "final":
        return raytpu.final_world(seed=seed)
    if name == "v1":
        # the v1 app's seven-sphere world (Shader_RT.fx:300-335)
        return raytpu.v1_world()
    raise SystemExit(f"unknown scene {name!r} (choose from {SCENES})")


def _build_camera(args, aspect):
    import raytpu
    return raytpu.make_camera(
        tuple(args.look_from), tuple(args.look_at), vfov=args.vfov,
        aspect=aspect, aperture=args.aperture,
        focus_dist=args.focus_dist)


def cmd_render(args) -> int:
    import raytpu
    from raytpu import io, profiling
    from raytpu.config import RenderConfig

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       depth=args.depth, rng_mode=args.rng_mode,
                       scatter_mode=args.scatter_mode, gamma=args.gamma)
    scene = _build_scene(args.scene, args.seed, args.scene_file)
    cam = _build_camera(args, cfg.aspect)

    from raytpu.render import _backend
    backend = _backend(args.backend, args.interpret)
    mesh = None
    if args.devices > 1:
        import jax
        from raytpu import shard
        if len(jax.devices()) < args.devices:
            raise SystemExit(f"--devices {args.devices}: only "
                             f"{len(jax.devices())} devices available")
        mesh = shard.make_mesh(jax.devices()[:args.devices])

    if args.progressive:
        from raytpu import progressive
        if mesh is not None and backend != "pallas":
            raise SystemExit(
                "--progressive with --devices runs the engine: use a GPU, "
                "or --interpret on the CPU")
        last = None
        for state, img in progressive.render_progressive(
                scene, cam, cfg, batch=args.progressive,
                checkpoint_path=args.checkpoint, resume=args.resume,
                backend=backend, mesh=mesh, interpret=args.interpret):
            print(f"samples {int(state.samples)}/{cfg.spp}",
                  file=sys.stderr)
            last = img
            if args.preview_every and (
                    int(state.samples) // args.progressive
                    ) % args.preview_every == 0:
                # the headless analogue of the reference's per-frame
                # window blit (CSVersion/ShaderDisplay.hlsl:18-31)
                io.save_image(args.out, img)
                print(f"preview @ {int(state.samples)} spp -> "
                      f"{args.out}", file=sys.stderr)
        if last is None:  # resumed fully-complete checkpoint
            from raytpu.progressive import load_checkpoint, image
            state, _ = load_checkpoint(args.checkpoint)
            last = image(state, cfg)
        img = last
        io.save_image(args.out, img)
        print(f"wrote {args.out}")
        return 0

    if mesh is not None:
        from raytpu import shard
        if backend == "pallas":
            def run():
                return shard.render_sharded_pallas(
                    scene, cam, cfg, mesh=mesh, interpret=args.interpret)
        else:
            def run():
                return shard.render_sharded(scene, cam, cfg, mesh=mesh)
    else:
        def run():
            return raytpu.render(scene, cam, cfg, backend=backend,
                                 interpret=args.interpret)
    img, stats = profiling.timed(run, cfg, label="render")
    io.save_image(args.out, img)
    print(f"wrote {args.out}  "
          f"({stats.rays_per_sec / 1e6:.2f} Mrays/s, "
          f"{stats.wall_s * 1e3:.1f} ms)")
    if args.log:
        profiling.log_run(args.log, stats, scene=args.scene,
                          backend=backend)
    return 0


def cmd_gradcheck(args) -> int:
    """Quick analytic-vs-finite-difference gradient self-check."""
    import jax
    import jax.numpy as jnp
    import raytpu
    from raytpu import golden
    from raytpu.config import RenderConfig

    cfg = RenderConfig(width=48, height=24, spp=2, depth=4)
    scene = raytpu.make_scene([
        ((0.0, -100.5, -1.0), 100.0, 0, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 0.0, -1.0), 0.5, 0, (0.7, 0.3, 0.3), 0.0),
    ])
    cam = raytpu.make_camera((0.0, 0.3, 1.5), (0.0, 0.0, -1.0), vfov=45.0,
                             aspect=cfg.aspect)
    px = jnp.array([22, 24, 26, 23], jnp.int32)
    py = jnp.array([12, 12, 13, 11], jnp.int32)

    @jax.jit
    def pix(s):
        r, g, b = golden.render_pixels(s, cam, cfg, px, py)
        return r + g + b

    def apply(v):
        return pix(scene._replace(albedo=scene.albedo.at[1, 0].set(v)))

    a0 = jnp.float32(0.7)
    analytic = jax.jvp(apply, (a0,), (jnp.float32(1.0),))[1]
    eps = 1e-2
    fd = (apply(a0 + eps) - apply(a0 - eps)) / (2 * eps)
    err = float(jnp.max(jnp.abs(analytic - fd)))
    print(json.dumps({"grad_max_err_vs_fd": err, "pass": err < 1e-3}))
    return 0 if err < 1e-3 else 1


def cmd_validate(args) -> int:
    """Scene lint + cross-backend consistency sweep (raytpu.debug).

    Exit 0 iff golden is finite and the engine agrees with it: compiled
    on a GPU within the f32-scheduling tolerance, BIT-identical in the
    Pallas interpreter on the CPU.  Scene lint findings are reported as
    warnings, not failures (e.g. random_world's energy-amplifying
    metal albedo is reference-faithful by design)."""
    import raytpu
    from raytpu import debug
    from raytpu.config import RenderConfig

    cfg = RenderConfig(width=args.width, height=args.height,
                       spp=args.spp, depth=args.depth,
                       scatter_mode=args.scatter_mode,
                       rng_mode=args.rng_mode)
    scene = _build_scene(args.scene, args.seed, args.scene_file)
    cam = _build_camera(args, cfg.aspect)
    rep = {"scene_warnings": debug.validate_scene(scene)}
    rep.update(debug.validate_backends(scene, cam, cfg))
    rep["pass"] = bool(rep["golden_finite"]
                       and rep.get("interpret_bit_identical", True)
                       and rep.get("compiled_ok", True))
    print(json.dumps(rep))
    return 0 if rep["pass"] else 1


def cmd_info(args) -> int:
    import jax
    import raytpu
    print(json.dumps({
        "version": raytpu.__version__,
        "platform": jax.devices()[0].platform,
        "devices": len(jax.devices()),
        "device_kind": jax.devices()[0].device_kind,
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to an image file")
    r.add_argument("--scene", choices=SCENES, default="test")
    r.add_argument("--scene-file", default=None, metavar="JSON",
                   help="load the scene from a JSON file "
                        "(raytpu.scene_io schema; overrides --scene)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--width", type=int, default=400)
    r.add_argument("--height", type=int, default=200)
    r.add_argument("--spp", type=int, default=20)
    r.add_argument("--depth", type=int, default=12)
    r.add_argument("--look-from", type=float, nargs=3,
                   default=[13.0, 2.0, 3.0])
    r.add_argument("--look-at", type=float, nargs=3,
                   default=[0.0, 0.0, 0.0])
    r.add_argument("--vfov", type=float, default=20.0)
    r.add_argument("--aperture", type=float, default=0.0)
    r.add_argument("--focus-dist", type=float, default=None)
    r.add_argument("--backend", choices=("auto", "golden", "pallas"),
                   default="auto",
                   help="auto = pallas (the engine) on a GPU, golden on "
                        "the CPU")
    r.add_argument("--interpret", action="store_true",
                   help="run the engine in the Pallas interpreter "
                        "(CPU testing)")
    r.add_argument("--gamma", type=float, default=2.2,
                   help="output gamma: 2.2 = v2's pow(1/2.2) "
                        "(ShaderCompute.hlsl:99), 2.0 = v1's sqrt "
                        "(Shader_RT.fx:448)")
    r.add_argument("--scatter-mode", choices=("v2", "v1"), default="v2",
                   help="material semantics generation (v1 = the pixel"
                        "-shader reference's hemisphere diffuse etc.)")
    r.add_argument("--rng-mode",
                   choices=("sequential", "parallel", "v1_fractsin"),
                   default="sequential",
                   help="sequential = reference-parity seed chain; "
                        "parallel = per-sample streams (faster grads)")
    r.add_argument("--progressive", type=int, default=0, metavar="BATCH",
                   help="render progressively in BATCH-sample steps")
    r.add_argument("--preview-every", type=int, default=0, metavar="K",
                   help="with --progressive: overwrite --out with the "
                        "current image every K batches (live preview)")
    r.add_argument("--checkpoint", default=None,
                   help="progressive checkpoint path (.npz)")
    r.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint")
    r.add_argument("--devices", type=int, default=1, metavar="N",
                   help="shard the render (or each --progressive batch) "
                        "over the first N devices as row slabs — "
                        "bit-identical output for any N")
    r.add_argument("--log", default=None, help="append run stats JSONL")
    r.add_argument("--out", default="out.png")
    r.set_defaults(fn=cmd_render)

    g = sub.add_parser("gradcheck", help="gradient vs finite-diff check")
    g.set_defaults(fn=cmd_gradcheck)

    v = sub.add_parser(
        "validate",
        help="scene lint + cross-backend consistency sweep")
    v.add_argument("--scene", choices=SCENES, default="test")
    v.add_argument("--scene-file", default=None, metavar="JSON")
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--width", type=int, default=96)
    v.add_argument("--height", type=int, default=48)
    v.add_argument("--spp", type=int, default=2)
    v.add_argument("--depth", type=int, default=5)
    v.add_argument("--scatter-mode", choices=("v2", "v1"), default="v2")
    v.add_argument("--rng-mode", choices=("sequential", "parallel"),
                   default="sequential")
    v.add_argument("--look-from", type=float, nargs=3,
                   default=[13.0, 2.0, 3.0])
    v.add_argument("--look-at", type=float, nargs=3,
                   default=[0.0, 0.0, 0.0])
    v.add_argument("--vfov", type=float, default=20.0)
    v.add_argument("--aperture", type=float, default=0.0)
    v.add_argument("--focus-dist", type=float, default=None)
    v.set_defaults(fn=cmd_validate)

    i = sub.add_parser("info", help="platform info")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
