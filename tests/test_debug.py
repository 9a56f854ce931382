"""Validation subsystem: checkify render, scene lint, backend sweep."""

import numpy as np
import jax.numpy as jnp
import pytest

import raytpu
from raytpu import debug
from raytpu.config import RenderConfig


CFG = RenderConfig(width=24, height=12, spp=1, depth=3)


def _cam():
    return raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                              vfov=20.0, aspect=CFG.aspect)


def test_checked_render_clean_scene():
    img = debug.checked_render(raytpu.test_world(), _cam(), CFG)
    assert np.isfinite(np.asarray(img)).all()


def test_checked_render_detects_nan():
    scene = raytpu.test_world()
    scene = scene._replace(center=scene.center.at[1, 0].set(jnp.nan))
    with pytest.raises(Exception):
        debug.checked_render(scene, _cam(), CFG)


def test_validate_scene_flags_problems():
    scene = raytpu.test_world()
    assert debug.validate_scene(scene) == []
    bad = scene._replace(
        radius=scene.radius.at[0].set(0.0),
        mat_type=scene.mat_type.at[1].set(7),
    )
    probs = debug.validate_scene(bad)
    assert any("zero radius" in p for p in probs)
    assert any("unknown material" in p for p in probs)
    amp = raytpu.random_world(seed=0)  # has metal albedo in [1, 1.5]
    assert any("energy-amplifying" in p for p in debug.validate_scene(amp))


def test_validate_backends_consistent():
    rep = debug.validate_backends(raytpu.test_world(), _cam(), CFG)
    assert rep["golden_finite"]
    assert rep["interpret_bit_identical"]


def test_device_ms_times_a_dispatch():
    """profiling.device_ms extracts a positive per-dispatch device time
    from a jax.profiler trace (CPU: XLA events land on the host pid)."""
    import jax
    import jax.numpy as jnp
    from raytpu import profiling

    f = jax.jit(lambda x: jnp.sum(x @ x))
    x = jnp.ones((256, 256), jnp.float32)
    float(f(x))  # compile outside the trace
    ms = profiling.device_ms(lambda: float(f(x)), pid_match="CPU")
    assert 0 < ms < 10_000


@pytest.mark.parametrize("events, want", [
    ([], 0.0),
    ([("k", 1.0, 2.0)], 2.0),
    ([("a", 0.0, 2.0), ("b", 1.0, 2.0)], 3.0),      # overlapping
    ([("a", 0.0, 5.0), ("b", 1.0, 1.0)], 5.0),      # nested
    ([("a", 0.0, 1.0), ("b", 3.0, 1.0)], 2.0),      # a gap is idle
    ([("b", 3.0, 1.0), ("a", 0.0, 1.0), ("c", 0.5, 1.0)], 2.5),
])
def test_busy_ms_is_the_union_of_intervals(events, want):
    """Device busy time: kernels on several streams overlap and must not
    count twice; gaps between them are idle."""
    from raytpu import profiling
    assert profiling.busy_ms(events) == pytest.approx(want)


def test_device_events_pick_the_default_device_plane():
    import jax
    import jax.numpy as jnp
    from raytpu import profiling

    f = jax.jit(lambda x: jnp.sum(x * 2.0))
    x = jnp.ones((64,), jnp.float32)
    float(f(x))
    evs = profiling.device_events(lambda: float(f(x)))
    assert evs and all(len(e) == 3 and e[2] >= 0 for e in evs)
    assert [e[2] for e in evs] == sorted((e[2] for e in evs), reverse=True)
