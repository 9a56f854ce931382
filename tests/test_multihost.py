"""Multi-host evidence on one machine: two CPU PROCESSES (not just a
virtual device mesh) render a sharded frame and psum gradients through
``shard.init_distributed`` + gloo collectives; results must bit-match
the single-process path.

Each worker owns ONE device, so every cross-device collective in the
sharded renderer/train step really crosses a process boundary — the
same code path several hosts take over their interconnect.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import sys
pid = int(sys.argv[1]); port = sys.argv[2]; outdir = sys.argv[3]
import jax
jax.config.update("jax_platforms", "cpu")
# initialize BEFORE any import that might touch the backend
from raytpu import shard
shard.init_distributed(f"localhost:{port}", num_processes=2,
                       process_id=pid, cpu_collectives="gloo")
import numpy as np
import jax.numpy as jnp
from raytpu.config import RenderConfig
import raytpu

assert jax.device_count() == 2 and jax.local_device_count() == 1
mesh = shard.make_mesh()
cfg = RenderConfig(width=64, height=32, spp=2, depth=3)
scene = raytpu.test_world()
cam = raytpu.make_camera((13., 2., 3.), (0., 0., 0.), vfov=20.,
                         aspect=cfg.aspect)
img = shard.render_sharded(scene, cam, cfg, mesh=mesh)

step = shard.make_train_step(cfg, mesh)
target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
scene1, cam1, loss = step(scene, cam, target)

# the image is sharded ACROSS PROCESSES: each rank owns one slab; save
# the addressable shard (the host test reassembles).  loss and the
# psum'd update are replicated, so any rank can materialize them.
sh = img.addressable_shards[0]
row0 = sh.index[0].start or 0
np.savez(outdir + f"/mp{pid}.npz",
         slab=np.asarray(sh.data), row0=np.asarray(row0),
         loss=np.asarray(loss), center=np.asarray(scene1.center))
print("WORKER_OK", pid, flush=True)
"""


def test_two_process_render_and_grads_match(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="/root/repo")
    env.pop("XLA_FLAGS", None)  # no virtual-device override here
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {i}" in out, out[-2000:]

    # single-process reference (in-process, 1-device mesh)
    import jax
    import jax.numpy as jnp
    from raytpu import shard
    from raytpu.config import RenderConfig
    import raytpu

    cfg = RenderConfig(width=64, height=32, spp=2, depth=3)
    scene = raytpu.test_world()
    cam = raytpu.make_camera((13., 2., 3.), (0., 0., 0.), vfov=20.,
                             aspect=cfg.aspect)
    mesh1 = shard.make_mesh(jax.devices()[:1])
    ref_img = np.asarray(shard.render_sharded(scene, cam, cfg, mesh=mesh1))
    step = shard.make_train_step(cfg, mesh1)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    ref_scene, ref_cam, ref_loss = step(scene, cam, target)

    got = np.zeros_like(ref_img)
    for i in range(2):
        with np.load(tmp_path / f"mp{i}.npz") as z:
            r0 = int(z["row0"])
            got[r0:r0 + z["slab"].shape[0]] = z["slab"]
            np.testing.assert_allclose(float(z["loss"]), float(ref_loss),
                                       rtol=1e-6)
            np.testing.assert_allclose(z["center"],
                                       np.asarray(ref_scene.center),
                                       rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got, ref_img)
