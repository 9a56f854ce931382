"""The Pallas-Triton engine in the interpreter: agreement with golden over
scenes, scatter generations, RNG modes and awkward frame shapes; block
padding and the block-size choice; row slabs and the carried-state
variant.  The engine keeps golden's op order, so every comparison here is
bitwise."""

import numpy as np
import jax.numpy as jnp
import pytest

import raytpu
from raytpu import golden
from raytpu.config import RenderConfig
from raytpu.kernels import megakernel

SCENES = {
    "test": raytpu.test_world,
    "config1": raytpu.config1_world,
    "random": lambda: raytpu.random_world(seed=3, half_extent=2),
}


def _cam(cfg, **kw):
    return raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=cfg.aspect, **kw)


def _engine(scene, cam, cfg, **kw):
    return np.asarray(megakernel.render_pallas(scene, cam, cfg,
                                               interpret=True, **kw))


def _golden(scene, cam, cfg):
    return np.asarray(golden.render_golden(scene, cam, cfg))


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
@pytest.mark.parametrize("scatter_mode", ["v2", "v1"])
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_engine_matches_golden(scene_name, scatter_mode, rng_mode):
    cfg = RenderConfig(width=16, height=8, spp=2, depth=3,
                       scatter_mode=scatter_mode, rng_mode=rng_mode)
    scene = SCENES[scene_name]()
    cam = _cam(cfg)
    np.testing.assert_array_equal(_engine(scene, cam, cfg),
                                  _golden(scene, cam, cfg))


@pytest.mark.parametrize("size", [(1, 1), (3, 1), (1, 5), (7, 3), (17, 5),
                                  (33, 2)])
def test_engine_degenerate_and_odd_shapes(size):
    """1x1 frames (jitter divides by max(dim - 1, 1)), single rows and
    columns, odd widths: the padded tail of the last block is dead and
    sliced off."""
    w, h = size
    cfg = RenderConfig(width=w, height=h, spp=2, depth=3)
    scene = raytpu.test_world()
    cam = _cam(cfg)
    got = _engine(scene, cam, cfg)
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _golden(scene, cam, cfg))


def test_engine_thin_lens():
    cfg = RenderConfig(width=16, height=8, spp=2, depth=3)
    scene = raytpu.test_world()
    cam = _cam(cfg, aperture=0.6, focus_dist=10.0)
    np.testing.assert_array_equal(_engine(scene, cam, cfg),
                                  _golden(scene, cam, cfg))


@pytest.mark.parametrize("n_pixels, block, lanes", [
    (1, None, 16),       # never below 16 lanes
    (16, None, 16),
    (17, None, 32),      # rounded up to a power of two
    (128, None, megakernel.BLOCK),
    (10_000, None, megakernel.BLOCK),
    (10_000, 256, 256),
    (100, 256, 128),     # a small slab shrinks the block
    (100, 16, 16),
])
def test_block_lanes(n_pixels, block, lanes):
    assert megakernel.block_lanes(n_pixels, block) == lanes


@pytest.mark.parametrize("block", [0, 3, 48])
def test_block_lanes_rejects_non_power_of_two(block):
    with pytest.raises(ValueError, match="power of two"):
        megakernel.block_lanes(1000, block)


@pytest.mark.parametrize("block, warps", [(16, 1), (32, 1), (64, 2),
                                          (128, 4), (256, 4)])
def test_num_warps(block, warps):
    assert megakernel.num_warps(block) == warps


@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_engine_block_invariant(block):
    """Lanes per program change the grid, never a pixel: 15 x 7 = 105
    pixels leave a partly dead last block for every block size."""
    cfg = RenderConfig(width=15, height=7, spp=2, depth=3)
    scene = raytpu.test_world()
    cam = _cam(cfg)
    np.testing.assert_array_equal(_engine(scene, cam, cfg, block=block),
                                  _golden(scene, cam, cfg))


@pytest.mark.parametrize("row0, rows", [(0, 3), (2, 3), (5, 4)])
def test_render_rows_is_a_slab_of_the_frame(row0, rows):
    """A slab renders the frame's own rows (absolute-coordinate seeds);
    rows past the frame render harmlessly and are cut here."""
    cfg = RenderConfig(width=9, height=7, spp=2, depth=3)
    scene = raytpu.test_world()
    cam = _cam(cfg)
    want = _golden(scene, cam, cfg)
    got = np.asarray(megakernel.render_rows(scene, cam, cfg, row0, rows,
                                            interpret=True))
    assert got.shape == (rows, cfg.width, 3)
    end = min(row0 + rows, cfg.height)
    np.testing.assert_array_equal(got[:end - row0], want[row0:end])


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_accumulate_pallas_slab_matches_frame(rng_mode):
    """The carried-state variant on a row slab equals the same rows of
    the full-frame batch, sums and seeds alike."""
    from raytpu import progressive
    cfg = RenderConfig(width=8, height=6, spp=3, depth=3, rng_mode=rng_mode)
    scene = raytpu.test_world()
    cam = _cam(cfg)
    st = progressive.init_state(cfg)
    acc, seed = megakernel.accumulate_pallas(
        scene, cam, cfg, st.acc, st.seed, jnp.uint32(0), 3, True)
    acc_s, seed_s = megakernel.accumulate_pallas(
        scene, cam, cfg, st.acc[2:5], st.seed[2:5], jnp.uint32(0), 3, True,
        2, 3)
    np.testing.assert_array_equal(np.asarray(acc_s), np.asarray(acc)[2:5])
    np.testing.assert_array_equal(np.asarray(seed_s), np.asarray(seed)[2:5])


def test_engine_refuses_v1_fractsin():
    cfg = RenderConfig(width=4, height=2, spp=1, depth=1,
                       rng_mode="v1_fractsin")
    with pytest.raises(ValueError, match="golden-only"):
        megakernel.render_pallas(raytpu.test_world(), _cam(cfg), cfg,
                                 interpret=True)


def test_pack_scene_layout():
    scene = raytpu.test_world()
    sc = np.asarray(megakernel.pack_scene(scene)).reshape(scene.count, -1)
    np.testing.assert_array_equal(sc[:, 0:3], np.asarray(scene.center))
    np.testing.assert_array_equal(sc[:, 3], np.asarray(scene.radius))
    np.testing.assert_array_equal(sc[:, 4], np.asarray(scene.mat_type))
    np.testing.assert_array_equal(sc[:, 5:8], np.asarray(scene.albedo))
    np.testing.assert_array_equal(sc[:, 8], np.asarray(scene.mat_param))
    assert (sc[:, 9:] == 0).all()
