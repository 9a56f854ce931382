"""Multi-device / multi-host sharding — pixel slabs over a device mesh.

The reference's only parallelism is the GPU thread grid (one thread per
pixel, ref: CSVersion/DxCSApp.cpp:524 Dispatch x ShaderCompute.hlsl:291
numthreads).  Across devices:

- **pixels sharded** over a 1-D ``jax.sharding.Mesh`` ('px'): each device
  renders a contiguous slab of the frame via ``jax.shard_map``.  RNG seeds
  derive from *absolute* pixel coordinates (raytpu/rng.py), so the image
  is bit-identical for every mesh size.  The cards of one host reach each
  other all to all over NVLink, so the mesh is 1-D: its shape follows
  the algorithm, not a torus.
- **scene + camera replicated** on every device (the analogue of the
  reference's cbuffer broadcast, ref: DxCSApp.cpp:393-413).
- **gradients psum'd** over the mesh: each device back-propagates its own
  pixels' loss into the replicated scene/camera parameters, then one
  ``jax.lax.psum`` (NCCL on the GPU) reduces a few KB of gradients.

Multi-host entry: call :func:`init_distributed` (a
``jax.distributed.initialize`` wrapper) before ``make_mesh()``; the mesh
then spans all processes' devices and shard_map does the rest.  The
two-process CPU test (tests/test_multihost.py) exercises this path end
to end.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from raytpu.camera import Camera
from raytpu.config import RenderConfig
from raytpu.scene import Scene
from raytpu import golden

AXIS = "px"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     cpu_collectives: str | None = None) -> None:
    """Initialize multi-host JAX before building a mesh.

    Thin wrapper over ``jax.distributed.initialize``.  Pass the
    coordinator address (``host:port``), the process count and this
    process's id; for the CPU-backend multi-process test path also pass
    ``cpu_collectives="gloo"``.  Call once per process; afterwards
    ``make_mesh()`` spans every process's devices and the sharded
    renderers / train steps work unchanged.

    Validated by tests/test_multihost.py: two CPU
    processes render one frame (one slab each) and psum gradients —
    both bit-match the single-process result.
    """
    if cpu_collectives:
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
    kwargs = {}
    if coordinator is not None:
        kwargs.update(coordinator_address=coordinator,
                      num_processes=num_processes,
                      process_id=process_id)
    jax.distributed.initialize(**kwargs)


def make_mesh(devices: Sequence[jax.Device] | None = None) -> Mesh:
    """1-D mesh over all (or the given) devices; axis name 'px'."""
    if devices is None:
        devices = jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), (AXIS,))


def _flat_pixel_ids(cfg: RenderConfig, n_shards: int):
    """Flattened pixel coords padded so each shard gets equal, chunk-aligned
    work. Pad pixels re-render pixel (0, h-1) and are sliced off."""
    h, w = cfg.height, cfg.width
    n = h * w
    per = -(-n // n_shards)
    # align to the chunk render_flat will recompute for this length
    # (min with per itself so the aligned length stays chunk-divisible)
    chunk = min(cfg.chunk_pixels, per)
    per = -(-per // chunk) * chunk
    total = per * n_shards
    flat = jnp.arange(total, dtype=jnp.int32)
    px = jnp.where(flat < n, flat % w, 0)
    py = jnp.where(flat < n, flat // w, h - 1)
    return px, py, n


@functools.partial(jax.jit, static_argnums=(2,), static_argnames=("mesh",))
def render_sharded(scene: Scene, cam: Camera, cfg: RenderConfig, *,
                   mesh: Mesh) -> jnp.ndarray:
    """Full-frame render with pixels sharded over ``mesh`` -> (H, W, 3).

    Bit-identical to :func:`raytpu.golden.render_golden` for any mesh size.
    """
    n_shards = mesh.devices.size
    px, py, n = _flat_pixel_ids(cfg, n_shards)

    def shard_fn(scene, cam, px, py):
        return golden.render_flat(scene, cam, cfg, px, py)

    colors = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P(AXIS)),
        out_specs=P(AXIS),
    )(scene, cam, px, py)
    return colors[:n].reshape(cfg.height, cfg.width, 3)


def slab_rows(height: int, n_shards: int) -> int:
    """Rows per device: the frame split evenly, the last slab padded
    (the engine renders padded rows harmlessly; they are sliced off)."""
    return -(-height // n_shards)


@functools.lru_cache(maxsize=16)
def _sharded_engine(cfg: RenderConfig, mesh: Mesh, interpret: bool):
    """One jitted sharded render per (cfg, mesh, interpret): a fresh
    closure per call would retrace and recompile every frame."""
    from raytpu.kernels import megakernel

    slab = slab_rows(cfg.height, mesh.devices.size)

    def shard_fn(scene, cam):
        row0 = jax.lax.axis_index(AXIS) * slab
        return megakernel.render_rows(scene, cam, cfg, row0, slab,
                                      interpret)

    # check_vma=False: a pure per-device map with no collectives (the
    # Pallas kernel's operands mix varying and unvaried values)
    sharded = jax.shard_map(shard_fn, mesh=mesh, in_specs=(P(), P()),
                            out_specs=P(AXIS), check_vma=False)
    return jax.jit(lambda scene, cam: sharded(scene, cam)[:cfg.height])


def render_sharded_pallas(scene: Scene, cam: Camera, cfg: RenderConfig, *,
                          mesh: Mesh, interpret: bool = False
                          ) -> jnp.ndarray:
    """The engine sharded over ``mesh``: one row slab per device.

    Each device runs the SAME compiled kernel on its slab — the absolute
    row offset is a traced kernel operand, and RNG seeds derive from
    absolute pixel coords, so the image is identical to the single-device
    engine render for any mesh size.
    """
    from raytpu.render import _backend

    _backend("pallas", interpret)
    return _sharded_engine(cfg, mesh, bool(interpret))(scene, cam)


def make_train_step_pallas(cfg: RenderConfig, mesh: Mesh,
                           lr: float = 1e-2, interpret: bool = False):
    """Train step on the engine: each device renders its row slab with
    the engine, back-propagates the MSE cotangent through the XLA
    adjoint of the same slab (raytpu/adjoint.py), and the scene/camera
    gradients are psum'd over the mesh; then one SGD step.

    step(scene, cam, target) -> (scene', cam', loss) like
    :func:`make_train_step`.
    """
    from raytpu import adjoint
    from raytpu.kernels import megakernel
    from raytpu.render import _backend

    _backend("pallas", interpret)
    n_shards = mesh.devices.size
    slab = slab_rows(cfg.height, n_shards)
    h_pad = slab * n_shards
    w = cfg.width
    inv_m = 1.0 / (cfg.height * w * 3)

    def shard_fn(scene, cam, target_slab):
        row0 = jax.lax.axis_index(AXIS) * slab
        img = megakernel.render_rows(scene, cam, cfg, row0, slab,
                                     interpret)
        # rows beyond the real image carry no loss
        valid = ((row0 + jnp.arange(slab)) < cfg.height)[:, None, None]
        diff = jnp.where(valid, img - target_slab, 0.0)
        loss = jax.lax.psum(jnp.sum(diff * diff) * inv_m, AXIS)
        ct = 2.0 * diff * inv_m
        _, vjp = jax.vjp(
            lambda s, c: adjoint.render_rows_adjoint(s, c, cfg, row0, slab),
            scene, cam)
        ds, dc = vjp(ct)
        ds = jax.lax.psum(ds._replace(mat_type=jnp.zeros(())), AXIS)
        dc = jax.lax.psum(dc, AXIS)
        return loss, ds, dc

    @jax.jit
    def step(scene: Scene, cam: Camera, target):
        tgt = jnp.zeros((h_pad, w, 3), jnp.float32).at[:cfg.height].set(
            jnp.asarray(target, jnp.float32))
        loss, ds, dc = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), P(AXIS)),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )(scene, cam, tgt)

        scene = scene._replace(
            center=scene.center - lr * ds.center,
            radius=scene.radius - lr * ds.radius,
            albedo=scene.albedo - lr * ds.albedo,
            mat_param=scene.mat_param - lr * ds.mat_param,
        )
        cam = cam._replace(
            origin=cam.origin - lr * dc.origin,
            horizontal=cam.horizontal - lr * dc.horizontal,
            vertical=cam.vertical - lr * dc.vertical,
            lower_left=cam.lower_left - lr * dc.lower_left,
        )
        return scene, cam, loss

    return step


def make_train_step(cfg: RenderConfig, mesh: Mesh, lr: float = 1e-2):
    """Build a jitted inverse-rendering train step over ``mesh``.

    step(scene, cam, target_image) -> (scene', cam', loss): renders the
    scene with pixels sharded over the mesh, computes MSE against the
    (replicated) target, back-propagates per-shard, psums scene+camera
    gradients over the mesh, and applies one SGD step to the continuous
    leaves.  This is the framework's "training step" — the differentiable
    -rendering optimization loop of BASELINE config 3 across devices.
    """
    n_shards = mesh.devices.size
    px, py, n = _flat_pixel_ids(cfg, n_shards)
    inv_n = 1.0 / (n * 3)

    def shard_fn(scene, cam, target, px, py):
        # differentiate w.r.t. the continuous leaves only (mat_type is
        # discrete: its float0 cotangent cannot ride a psum)
        def local_loss(params, cam):
            scene_ = scene._replace(**params)
            colors = golden.render_flat(scene_, cam, cfg, px, py)
            tgt = target.reshape(-1, 3)[py * cfg.width + px]
            keep = (jax.lax.axis_index(AXIS) * px.shape[0]
                    + jnp.arange(px.shape[0])) < n
            d2 = jnp.sum((colors - tgt) ** 2, axis=-1)
            return jnp.sum(jnp.where(keep, d2, 0.0)) * inv_n

        params = dict(center=scene.center, radius=scene.radius,
                      albedo=scene.albedo, mat_param=scene.mat_param)
        loss, grads = jax.value_and_grad(
            local_loss, argnums=(0, 1))(params, cam)
        # loss is a varying per-shard partial -> explicit psum.  grads are
        # NOT psum'd here: under shard_map's varying-axis tracking the
        # transpose of "consume a replicated input" already inserts the
        # cross-shard psum (the gradient all-reduce of a few KB of
        # scene/camera grads).
        loss = jax.lax.psum(loss, AXIS)
        return loss, grads

    @jax.jit
    def step(scene: Scene, cam: Camera, target):
        loss, (gp, gc) = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(AXIS), P(AXIS)),
            out_specs=(P(), (P(), P())),
        )(scene, cam, target, px, py)

        scene = scene._replace(
            **{k: getattr(scene, k) - lr * gp[k] for k in gp})
        cam = cam._replace(
            origin=cam.origin - lr * gc.origin,
            horizontal=cam.horizontal - lr * gc.horizontal,
            vertical=cam.vertical - lr * gc.vertical,
            lower_left=cam.lower_left - lr * gc.lower_left,
        )
        return scene, cam, loss

    return step
