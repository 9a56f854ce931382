"""Progressive accumulation: batching invariance + checkpoint round-trip."""

import numpy as np
import jax.numpy as jnp

import raytpu
from raytpu import golden, progressive
from raytpu.config import RenderConfig


CFG = RenderConfig(width=40, height=24, spp=6, depth=3, chunk_pixels=128)


def _scene_cam():
    scene = raytpu.test_world()
    cam = raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                             aspect=CFG.aspect)
    return scene, cam


def test_batched_equals_oneshot():
    """2+3+1 samples threaded through carried state == one 6-sample batch,
    bit-exactly; and matches render_golden to fusion-level rounding (the
    gamma epilogue fuses differently across the two jit programs)."""
    scene, cam = _scene_cam()

    one = progressive.init_state(CFG)
    one = progressive.accumulate(scene, cam, CFG, one, 6)

    state = progressive.init_state(CFG)
    for step in (2, 3, 1):
        state = progressive.accumulate(scene, cam, CFG, state, step)
    assert int(state.samples) == 6
    np.testing.assert_array_equal(np.asarray(state.acc), np.asarray(one.acc))
    np.testing.assert_array_equal(np.asarray(state.seed),
                                  np.asarray(one.seed))

    want = np.asarray(golden.render_golden(scene, cam, CFG))
    got = np.asarray(progressive.image(state, CFG))
    np.testing.assert_allclose(got, want, atol=2e-7)


def test_checkpoint_roundtrip(tmp_path):
    scene, cam = _scene_cam()
    path = str(tmp_path / "ckpt.npz")

    state = progressive.init_state(CFG)
    state = progressive.accumulate(scene, cam, CFG, state, 2)
    progressive.save_checkpoint(path, state, CFG)

    loaded, cfg2 = progressive.load_checkpoint(path)
    assert cfg2 == CFG
    np.testing.assert_array_equal(np.asarray(loaded.acc),
                                  np.asarray(state.acc))
    np.testing.assert_array_equal(np.asarray(loaded.seed),
                                  np.asarray(state.seed))

    # resuming from the checkpoint completes to the one-shot image
    state_r = progressive.accumulate(scene, cam, CFG, loaded, 4)
    want = np.asarray(golden.render_golden(scene, cam, CFG))
    np.testing.assert_allclose(
        np.asarray(progressive.image(state_r, CFG)), want, atol=2e-7)


def test_generator_interface(tmp_path):
    scene, cam = _scene_cam()
    path = str(tmp_path / "gen.npz")
    images = [img for _, img in progressive.render_progressive(
        scene, cam, CFG, batch=4, checkpoint_path=path)]
    assert len(images) == 2  # 4 + 2
    want = np.asarray(golden.render_golden(scene, cam, CFG))
    np.testing.assert_allclose(np.asarray(images[-1]), want, atol=2e-7)

    # a fresh generator resuming from disk has nothing left to do
    resumed = list(progressive.render_progressive(
        scene, cam, CFG, batch=4, checkpoint_path=path, resume=True))
    assert resumed == []


def test_parallel_mode_batching_bit_exact():
    """Parallel RNG mode: globally-indexed sample streams make batched
    accumulation bit-exact too (s0 offsets, not carried seeds)."""
    cfg = CFG.replace(rng_mode="parallel")
    scene, cam = _scene_cam()

    one = progressive.init_state(cfg)
    one = progressive.accumulate(scene, cam, cfg, one, 6)

    state = progressive.init_state(cfg)
    for step in (2, 3, 1):
        state = progressive.accumulate(scene, cam, cfg, state, step)
    np.testing.assert_array_equal(np.asarray(state.acc),
                                  np.asarray(one.acc))

    want = np.asarray(golden.render_golden(scene, cam, cfg))
    np.testing.assert_allclose(
        np.asarray(progressive.image(state, cfg)), want, atol=2e-7)


def test_pallas_accumulate_matches_golden():
    """Engine carry-state accumulation == golden path, bit-exact, in both
    RNG modes (and one compilation across batches)."""
    scene, cam = _scene_cam()
    for mode in ("sequential", "parallel"):
        cfg = CFG.replace(rng_mode=mode)
        want = progressive.init_state(cfg)
        got = progressive.init_state(cfg)
        for step in (2, 3, 1):
            want = progressive.accumulate(scene, cam, cfg, want, step)
            got = progressive.accumulate(scene, cam, cfg, got, step,
                                         backend="pallas", interpret=True)
        np.testing.assert_array_equal(np.asarray(got.acc),
                                      np.asarray(want.acc))
        np.testing.assert_array_equal(np.asarray(got.seed),
                                      np.asarray(want.seed))


def test_sharded_accumulate_matches_unsharded():
    """Mesh-sharded progressive accumulation (row slabs) is BIT-identical
    to the unsharded pallas path in both RNG modes, and a mid-render
    state migrates between mesh sizes (4 -> 2 -> unsharded)."""
    import jax
    from raytpu import shard

    scene, cam = _scene_cam()
    mesh4 = shard.make_mesh(jax.devices()[:4])
    mesh2 = shard.make_mesh(jax.devices()[:2])
    for mode in ("sequential", "parallel"):
        cfg = CFG.replace(rng_mode=mode)
        want = progressive.init_state(cfg)
        got = progressive.init_state(cfg)
        for step, mesh in ((2, mesh4), (3, mesh2), (1, None)):
            want = progressive.accumulate(scene, cam, cfg, want, step,
                                          backend="pallas", interpret=True)
            got = progressive.accumulate(scene, cam, cfg, got, step,
                                         backend="pallas", mesh=mesh,
                                         interpret=True)
        np.testing.assert_array_equal(np.asarray(got.acc),
                                      np.asarray(want.acc))
        np.testing.assert_array_equal(np.asarray(got.seed),
                                      np.asarray(want.seed))
