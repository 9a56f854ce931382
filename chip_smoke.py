"""Run raytpu's main path once on one GPU and check what comes out.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the sharded paths only

Phases, all through the public entry points, each raising on failure:

0. precision: Triton's and XLA's f32 division, sqrt, rsqrt, exp, log,
   sin and cos against correctly rounded results;
1. forward: ``raytpu.render`` (the Pallas-Triton engine) at REFERENCE_V2
   (random_world, 1024x576, 60 spp, depth 50; also at depth 1, under a
   tighter bound) and at config 4 @ 20 spp, each against
   ``golden.render_golden`` on the card, and on a reduced frame against
   the spread of golden between the card and the host CPU;
2. gradients: ``render_grad`` at config 2 against ``jax.grad`` of golden,
   ``jax.grad`` through ``render`` against ``render_grad``, and finite
   gradients at config 4 @ 20 spp;
3. optimiser: three Adam steps of the config-3 defocus + vis_w loop;
4. progressive: 10 + 10 spp against one 20-spp batch, and a checkpoint
   round trip;
5. CLI: ``cli.main(["render", ...])`` and ``cli.main(["validate", ...])``
   in this process (a second process could not open the card).

With ``--devices 4`` the script runs only the sharded paths, each against
the same call on one card: ``shard.render_sharded_pallas`` at 1920x1080,
depth 12, 20 spp; ``make_train_step_pallas`` and ``make_train_step``;
``progressive.accumulate(mesh=)``.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.  Without a GPU,
or without the raytpu package beside it, the script exits non-zero and
prints no result.  The phase functions are plain functions:
tests/test_chip_smoke.py runs them at tiny sizes in interpret mode.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import raytpu  # noqa: E402
from raytpu import golden  # noqa: E402
from raytpu.config import RenderConfig  # noqa: E402

# -- tolerances --------------------------------------------------------------
# Engine vs golden, both compiled for the card.  Their f32 evaluation
# orders differ (FMA contraction, operation scheduling), and the r=1000
# ground's discriminant is a catastrophic cancellation, so a hit point
# moves by a few ulps and a path that grazes a silhouette or a Schlick
# threshold takes the other branch.  Phase 0 shows the elementary
# functions themselves agree: Triton and XLA both lower division to an
# approximation that is not correctly rounded (<= 2 ulp), and
# sqrt/rsqrt/exp/log/sin/cos to the same <= 2-ulp results, so the
# bounds need no allowance for them.  A branch flip changes a pixel by up to
# 1/spp of its radiance, so the per-pixel bound (3e-4) holds for all
# but the pixels whose paths flipped; their share and the mean |diff|
# grow with depth and scene size.  golden itself shows the same spread
# between the card and the host CPU (the control below), so the bounds
# follow that spread: at REFERENCE_V2 on an H100 80GB HBM3 (700 W) the
# engine measured 3.5% outliers and mean |diff| 2.5e-4; on a reduced
# frame of the same scene golden card-vs-host measured 2.0% and 7.6e-4,
# the engine against golden 0.4% and 1.4e-4.
PIXEL_ATOL = 3e-4
MAX_OUTLIER_FRAC = 0.05
MAX_MEAN_ABS = 5e-4
# at depth 1 nothing has bounced: the bound the full-depth image would
# meet if f32 evaluation order could not flip a branch
STRICT_OUTLIER_FRAC = 1e-3
STRICT_MEAN_ABS = 1e-4
# flips are unbiased: the image-mean signed difference stays small
MAX_MEAN_SIGNED = 1e-4
# gradients: per leaf, max |a - b| / max |b|
GRAD_RTOL = 2e-3
# the same engine forward and the same adjoint; only the order in which
# the scatter-add's atomics sum differs between two compiled programs
SAME_PATH_RTOL = 1e-5
MAX_ULP = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, read by a child process
    that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def timed(name: str, fn, *args):
    """First call (compile + run) and one steady call, both ended by
    ``block_until_ready``; prints both times and returns the result."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t2 = time.perf_counter()
    log(f"[{name}] compile+first {t1 - t0:.3f} s  steady {t2 - t1:.4f} s")
    return out


def image_stats(img, ref) -> dict:
    img, ref = np.asarray(img), np.asarray(ref)
    d = np.abs(img - ref)
    return {"max_abs": float(d.max()),
            "outlier_frac": float((d > PIXEL_ATOL).mean()),
            "mean_abs": float(d.mean()),
            "mean_signed": float((img - ref).mean())}


def check_image(name: str, img, ref, max_frac=MAX_OUTLIER_FRAC,
                max_mean=MAX_MEAN_ABS) -> dict:
    img = np.asarray(img)
    if img.shape != np.shape(ref) or not np.isfinite(img).all():
        raise AssertionError(f"{name}: shape {img.shape} or non-finite")
    st = image_stats(img, ref)
    log(f"[{name}] outliers (|diff| > {PIXEL_ATOL}) {st['outlier_frac']:.5f}"
        f" <= {max_frac:.5f}; mean |diff| {st['mean_abs']:.3e} <= "
        f"{max_mean:.3e}; mean diff {st['mean_signed']:.3e} within "
        f"+-{MAX_MEAN_SIGNED:.0e}; max |diff| {st['max_abs']:.3e}")
    if (st["outlier_frac"] > max_frac or st["mean_abs"] > max_mean
            or abs(st["mean_signed"]) > MAX_MEAN_SIGNED):
        raise AssertionError(f"{name}: engine vs golden out of tolerance")
    return st


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def camera(cfg: RenderConfig, **kw):
    return raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=cfg.aspect, **kw)


def _golden(cfg: RenderConfig):
    return jax.jit(lambda s, c: golden.render_golden(s, c, cfg))


def _engine(cfg: RenderConfig, interpret: bool):
    return jax.jit(lambda s, c: raytpu.render(s, c, cfg,
                                              interpret=interpret))


# -- phase 0 -----------------------------------------------------------------

def phase_precision(n: int = 1 << 20, interpret: bool = False) -> dict:
    """ulps from the correctly rounded f32 result, Triton vs XLA."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    def ops(a, b):
        return (a / b, jnp.sqrt(a), jax.lax.rsqrt(a), jnp.exp(a * 0.05),
                jnp.log(a), jnp.sin(a), jnp.cos(a))

    names = ("div", "sqrt", "rsqrt", "exp", "log", "sin", "cos")
    r = np.random.default_rng(0)
    x = r.uniform(0.01, 100.0, n).astype(np.float32)
    y = r.uniform(0.01, 100.0, n).astype(np.float32)
    blk = min(n, 1024)
    spec = pl.BlockSpec((blk,), lambda i: (i,))

    def kernel(x_ref, y_ref, *outs):
        for o, v in zip(outs, ops(x_ref[...], y_ref[...])):
            o[...] = v

    tri = pl.pallas_call(
        kernel, grid=(n // blk,), in_specs=[spec, spec],
        out_specs=[spec] * 7,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32)] * 7,
        backend="triton", compiler_params=plt.CompilerParams(num_warps=4),
        interpret=interpret)(x, y)
    xla = jax.jit(ops)(x, y)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    a05 = (x * np.float32(0.05)).astype(np.float64)
    exact = (x64 / y64, np.sqrt(x64), 1.0 / np.sqrt(x64), np.exp(a05),
             np.log(x64), np.sin(x64), np.cos(x64))
    out = {}
    for nm, t, xv, ex in zip(names, tri, xla, exact):
        rn = ex.astype(np.float32).view(np.int32).astype(np.int64)

        def ulps(v):
            return np.abs(np.asarray(v).view(np.int32).astype(np.int64) - rn)

        ut, ux = ulps(t), ulps(xv)
        out[nm] = {"triton_max_ulp": int(ut.max()),
                   "triton_frac_not_rn": float((ut > 0).mean()),
                   "xla_max_ulp": int(ux.max()),
                   "xla_frac_not_rn": float((ux > 0).mean())}
        log(f"[precision] {nm}: triton max {ut.max()} ulp "
            f"({(ut > 0).mean():.3f} not correctly rounded), xla max "
            f"{ux.max()} ulp ({(ux > 0).mean():.3f}); bound {MAX_ULP}")
        if ut.max() > MAX_ULP or ux.max() > MAX_ULP:
            raise AssertionError(f"precision: {nm} beyond {MAX_ULP} ulp")
    return out


# -- phase 1 -----------------------------------------------------------------

def phase_forward(cfg: RenderConfig, scene, cam, name: str,
                  interpret: bool = False) -> dict:
    """The engine through ``raytpu.render`` against golden, same device."""
    img = timed(f"{name} engine", _engine(cfg, interpret), scene, cam)
    ref = timed(f"{name} golden", _golden(cfg), scene, cam)
    return check_image(name, img, ref)


def phase_forward_depth1(cfg: RenderConfig, scene, cam, name: str,
                         interpret: bool = False) -> dict:
    """Camera rays, one closest hit, sky: no path can branch on an
    earlier bounce, so the tight bound holds."""
    cfg = cfg.replace(depth=1)
    img = _engine(cfg, interpret)(scene, cam)
    ref = _golden(cfg)(scene, cam)
    return check_image(name, img, ref, max_frac=STRICT_OUTLIER_FRAC,
                       max_mean=STRICT_MEAN_ABS)


def phase_control(cfg: RenderConfig, scene, cam,
                  interpret: bool = False) -> dict:
    """golden on the default device against golden on the host CPU, and
    the engine against golden, on one reduced frame: the engine may not
    part from golden more than golden parts from itself across
    backends."""
    ref = np.asarray(_golden(cfg)(scene, cam))
    host = jax.devices("cpu")[0]
    s_h, c_h = jax.device_put((scene, cam), host)
    ref_host = np.asarray(_golden(cfg)(s_h, c_h))
    spread = image_stats(ref, ref_host)
    log(f"[control] golden device vs host: outliers "
        f"{spread['outlier_frac']:.5f}, mean |diff| {spread['mean_abs']:.3e}")
    img = _engine(cfg, interpret)(scene, cam)
    return check_image("control engine", img, ref,
                       max_frac=spread["outlier_frac"],
                       max_mean=spread["mean_abs"])


# -- phase 2 -----------------------------------------------------------------

_LEAVES = ("center", "radius", "albedo", "mat_param")
_CAM_LEAVES = ("horizontal", "vertical", "lower_left")


def phase_gradients(cfg: RenderConfig, scene, cam,
                    interpret: bool = False) -> dict:
    """``render_grad`` vs ``jax.grad`` of golden (precision "highest"),
    and ``jax.grad`` through ``render`` vs ``render_grad``."""
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    loss_rg, _, (gs, gc) = timed(
        "grad render_grad",
        lambda s, c: raytpu.render_grad(s, c, cfg, target,
                                        interpret=interpret), scene, cam)

    def loss_golden(s, c):
        return jnp.mean((golden.render_golden(s, c, cfg) - target) ** 2)

    def loss_render(s, c):
        return jnp.mean(
            (raytpu.render(s, c, cfg, interpret=interpret) - target) ** 2)

    with jax.default_matmul_precision("highest"):
        rs, rc = timed("grad golden autodiff", jax.jit(jax.grad(
            loss_golden, argnums=(0, 1), allow_int=True)), scene, cam)
    ts, tc = timed("grad through render", jax.jit(jax.grad(
        loss_render, argnums=(0, 1), allow_int=True)), scene, cam)
    out = {"loss": float(loss_rg)}
    pairs = ([(k, getattr(gs, k), getattr(rs, k), getattr(ts, k))
              for k in _LEAVES]
             + [(k, getattr(gc, k), getattr(rc, k), getattr(tc, k))
                for k in _CAM_LEAVES])
    for k, a, ref, via_render in pairs:
        e, s = rel_err(a, ref), rel_err(via_render, a)
        out[k] = e
        log(f"[grad] {k}: render_grad vs golden autodiff {e:.2e} <= "
            f"{GRAD_RTOL:.0e}; grad through render vs render_grad {s:.2e}"
            f" <= {SAME_PATH_RTOL:.0e}")
        if e > GRAD_RTOL or s > SAME_PATH_RTOL:
            raise AssertionError(f"gradients: {k} out of tolerance")
    # the camera origin is a cancelling sum: d/d origin = (sum of
    # per-ray origin terms) - d/d lower_left, two sums of the size of
    # the lower_left gradient.  Its f32 noise scales with that size,
    # so it is judged against it.
    scale = max(np.abs(np.asarray(rc.lower_left)).max(),
                np.abs(np.asarray(rc.origin)).max())
    e = float(np.abs(np.asarray(gc.origin) - np.asarray(rc.origin)).max()
              / scale)
    s = rel_err(tc.origin, gc.origin)
    out["origin"] = e
    log(f"[grad] origin: |render_grad - golden| / max(|d lower_left|, "
        f"|d origin|) {e:.2e} <= {GRAD_RTOL:.0e}; grad through render vs "
        f"render_grad {s:.2e} <= {SAME_PATH_RTOL:.0e}")
    if e > GRAD_RTOL or s > SAME_PATH_RTOL:
        raise AssertionError("gradients: origin out of tolerance")
    return out


def phase_grad_finite(cfg: RenderConfig, scene, cam,
                      interpret: bool = False) -> dict:
    target = jnp.full((cfg.height, cfg.width, 3), 0.5, jnp.float32)
    loss, img, (gs, gc) = timed(
        "grad finite",
        lambda s, c: raytpu.render_grad(s, c, cfg, target,
                                        interpret=interpret), scene, cam)
    leaves = [getattr(gs, k) for k in _LEAVES] + list(gc)
    ok = all(bool(np.isfinite(np.asarray(v)).all()) for v in leaves)
    log(f"[grad finite] loss {float(loss):.5f}, every gradient finite: {ok}")
    if not (ok and np.isfinite(float(loss))):
        raise AssertionError("gradients: non-finite")
    return {"loss": float(loss)}


# -- phase 3 -----------------------------------------------------------------

def phase_adam(size=(400, 200), steps: int = 3, vis_w: float = 0.005,
               lr: float = 0.01, interpret: bool = False) -> list:
    """Adam on the hero sphere's center with silhouette gradients: the
    defocus-camera problem of examples/inverse_render.py (config 3)."""
    import importlib.util
    from raytpu.optim import optimize

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "inverse_render.py")
    spec = importlib.util.spec_from_file_location("inverse_render", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg, scene_true, scene0, cam, _ = example.make_problem(size=size)
    # the target through the same entry point as the loss
    target = raytpu.render(scene_true, cam, cfg, interpret=interpret)

    def loss_fn(hero):
        scene = scene0._replace(center=scene0.center.at[1].set(hero))
        img = raytpu.render(scene, cam, cfg, interpret=interpret,
                            vis_w=vis_w)
        return jnp.mean((img - target) ** 2)

    t0 = time.perf_counter()
    _, losses = optimize(loss_fn, scene0.center[1], steps=steps, lr=lr)
    log(f"[adam] {steps} steps in {time.perf_counter() - t0:.3f} s "
        f"(first compiles), losses {losses}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"adam: loss not finite and falling {losses}")
    return losses


# -- phase 4 -----------------------------------------------------------------

def phase_progressive(cfg: RenderConfig, scene, cam, batch: int,
                      interpret: bool = False) -> dict:
    """``batch`` + ``batch`` spp through the engine == one 2*batch
    batch, bitwise (parallel RNG); the image matches ``render``; a
    checkpoint round trip resumes to the same state."""
    from raytpu import progressive as pg

    cfg = cfg.replace(spp=2 * batch, rng_mode="parallel")

    def acc(state, spp):
        return pg.accumulate(scene, cam, cfg, state, spp, backend="pallas",
                             interpret=interpret)

    one = timed("progressive one batch",
                lambda: acc(pg.init_state(cfg), 2 * batch).acc)
    half = acc(pg.init_state(cfg), batch)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        pg.save_checkpoint(path, half, cfg)
        loaded, cfg2 = pg.load_checkpoint(path)
    if cfg2 != cfg or not np.array_equal(np.asarray(loaded.acc),
                                         np.asarray(half.acc)):
        raise AssertionError("progressive: checkpoint round trip differs")
    two = acc(loaded, batch)
    same = bool(np.array_equal(np.asarray(two.acc), np.asarray(one)))
    img = np.asarray(pg.image(two, cfg))
    full = np.asarray(raytpu.render(scene, cam, cfg, interpret=interpret))
    d = float(np.abs(img - full).max())
    log(f"[progressive] {batch}+{batch} spp == {2 * batch} spp bitwise: "
        f"{same}; image vs render max |diff| {d:.2e} <= 1e-5")
    if not same or d > 1e-5:
        raise AssertionError("progressive: batches differ")
    return {"bit_equal": same, "image_max_abs": d}


# -- phase 5 -----------------------------------------------------------------

def phase_cli(size=(96, 48), interpret: bool = False) -> None:
    from raytpu import cli

    w, h = (str(v) for v in size)
    extra = ["--interpret"] if interpret else []
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "cli.png")
        t0 = time.perf_counter()
        rc = cli.main(["render", "--scene", "random", "--width", w,
                       "--height", h, "--spp", "4", "--depth", "8",
                       "--out", out] + extra)
        ok = rc == 0 and os.path.getsize(out) > 0
    log(f"[cli render] rc {rc} in {time.perf_counter() - t0:.3f} s")
    if not ok:
        raise AssertionError("cli render failed")
    if not interpret:
        t0 = time.perf_counter()
        rc = cli.main(["validate", "--scene", "random", "--width", w,
                       "--height", h])
        log(f"[cli validate] rc {rc} in {time.perf_counter() - t0:.3f} s")
        if rc != 0:
            raise AssertionError("cli validate failed")


# -- four cards --------------------------------------------------------------

def phase_sharded(devices, cfg: RenderConfig, scene, cam,
                  train_cfg: RenderConfig, train_scene,
                  interpret: bool = False) -> dict:
    """The sharded paths on ``devices`` against the same call on one."""
    from raytpu import progressive as pg
    from raytpu import shard

    many = shard.make_mesh(devices)
    one = shard.make_mesh(devices[:1])
    n = len(devices)
    out = {}

    def render_on(mesh):
        return lambda: shard.render_sharded_pallas(
            scene, cam, cfg, mesh=mesh, interpret=interpret)

    a = np.asarray(timed(f"sharded render x{n}", render_on(many)))
    b = np.asarray(timed("sharded render x1", render_on(one)))
    out["render_bit_equal"] = bool(np.array_equal(a, b))
    log(f"[sharded render] {cfg.width}x{cfg.height} x{n} == x1 bitwise: "
        f"{out['render_bit_equal']}")
    if not out["render_bit_equal"] or not np.isfinite(a).all():
        raise AssertionError("sharded render differs across mesh sizes")

    tcam = camera(train_cfg)
    target = golden.render_golden(train_scene, tcam, train_cfg)
    scene0 = train_scene._replace(
        albedo=train_scene.albedo.at[1].set(jnp.asarray([0.3, 0.6, 0.5])))
    for name, make in (
            ("train_step_pallas",
             lambda m: shard.make_train_step_pallas(train_cfg, m, lr=1.0,
                                                    interpret=interpret)),
            ("train_step", lambda m: shard.make_train_step(train_cfg, m,
                                                           lr=1.0))):
        res = []
        for mesh, k in ((many, n), (one, 1)):
            step = make(mesh)
            res.append(timed(f"{name} x{k}", step, scene0, tcam, target))
        (s_a, c_a, l_a), (s_b, c_b, l_b) = res
        errs = {"loss": rel_err(l_a, l_b)}
        for k in _LEAVES:
            errs[k] = rel_err(np.asarray(getattr(scene0, k))
                              - np.asarray(getattr(s_a, k)),
                              np.asarray(getattr(scene0, k))
                              - np.asarray(getattr(s_b, k)))
        out[name] = errs
        log(f"[{name}] x{n} vs x1 relative errors {errs} <= "
            f"{SAME_PATH_RTOL:.0e}")
        if max(errs.values()) > SAME_PATH_RTOL:
            raise AssertionError(f"{name}: x{n} differs from x1")

    pcfg = cfg.replace(spp=4, rng_mode="parallel")
    st = []
    for mesh, k in ((many, n), (one, 1)):
        state = pg.init_state(pcfg)
        t0 = time.perf_counter()
        for _ in range(2):
            state = pg.accumulate(scene, cam, pcfg, state, 2,
                                  backend="pallas", mesh=mesh,
                                  interpret=interpret)
        jax.block_until_ready(state.acc)
        log(f"[progressive mesh x{k}] 2 batches in "
            f"{time.perf_counter() - t0:.3f} s")
        st.append(state)
    out["progressive_bit_equal"] = bool(
        np.array_equal(np.asarray(st[0].acc), np.asarray(st[1].acc))
        and np.array_equal(np.asarray(st[0].seed), np.asarray(st[1].seed)))
    log(f"[progressive mesh] x{n} == x1 bitwise: "
        f"{out['progressive_bit_equal']}")
    if not out["progressive_bit_equal"]:
        raise AssertionError("sharded progressive differs across meshes")
    for d in devices:
        log(f"[memory] {d}: {d.memory_stats()}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1,
                   help="4 runs the sharded paths on four cards only")
    args = p.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < args.devices:
        raise SystemExit(f"chip_smoke: --devices {args.devices} but JAX "
                         f"found {len(devs)}")
    log(card_line())
    log(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    t_all = time.perf_counter()
    from raytpu.config import CONFIG2, REFERENCE_V2

    if args.devices > 1:
        cfg = RenderConfig(width=1920, height=1080, spp=20, depth=12)
        phase_sharded(devs[:args.devices], cfg, raytpu.final_world(),
                      camera(cfg),
                      RenderConfig(width=800, height=400, spp=4, depth=12),
                      raytpu.test_world())
    else:
        phase_precision()
        scene = raytpu.random_world()
        phase_forward_depth1(REFERENCE_V2, scene,
                             raytpu.reference_camera_v2(),
                             "forward REFERENCE_V2 depth 1")
        phase_forward(REFERENCE_V2, scene, raytpu.reference_camera_v2(),
                      "forward REFERENCE_V2")
        cfg4 = RenderConfig(width=800, height=400, spp=20, depth=12)
        phase_forward(cfg4, raytpu.final_world(), camera(cfg4),
                      "forward config4@20")
        small = REFERENCE_V2.replace(width=128, height=72, spp=8)
        phase_control(small, scene, raytpu.reference_camera_v2())
        phase_gradients(CONFIG2, raytpu.config2_world(), camera(CONFIG2))
        phase_grad_finite(cfg4, raytpu.final_world(), camera(cfg4))
        phase_adam()
        phase_progressive(CONFIG2, raytpu.config2_world(), camera(CONFIG2),
                          batch=10)
        phase_cli()
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
