"""Device choice and the compile cache.

``render._backend`` picks the engine on a GPU and golden on the CPU and
refuses anything else; the interpreter runs only when a caller passes
``interpret=True``.  The compile cache follows
``JAX_COMPILATION_CACHE_DIR`` or a fixed path in the checkout."""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import pytest

import raytpu
from raytpu import progressive, shard
from raytpu.config import RenderConfig
from raytpu.render import _backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(width=4, height=2, spp=1, depth=1)


def _on(monkeypatch, platform):
    dev = types.SimpleNamespace(platform=platform)
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])


@pytest.mark.parametrize("name, platform, interpret, want", [
    ("auto", "gpu", False, "pallas"),
    ("auto", "cpu", False, "golden"),
    ("auto", "cpu", True, "pallas"),
    ("golden", "gpu", False, "golden"),
    ("pallas", "gpu", False, "pallas"),
    ("pallas", "cpu", True, "pallas"),
])
def test_backend_choice(monkeypatch, name, platform, interpret, want):
    _on(monkeypatch, platform)
    assert _backend(name, interpret) == want


@pytest.mark.parametrize("name, platform, match", [
    ("auto", "METAL", "no renderer"),
    ("auto", "neuron", "no renderer"),
    ("pallas", "cpu", "interpret=True"),
    ("wavefront", "gpu", "unknown backend"),
])
def test_backend_errors(monkeypatch, name, platform, match):
    _on(monkeypatch, platform)
    with pytest.raises(ValueError, match=match):
        _backend(name)


def _cam():
    return raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=CFG.aspect)


@pytest.mark.parametrize("call", [
    "render", "render_grad", "render_sharded_pallas",
    "make_train_step_pallas", "accumulate",
])
def test_engine_on_cpu_needs_explicit_interpret(call):
    """No entry point falls back to the interpreter by itself."""
    scene, cam = raytpu.test_world(), _cam()
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    mesh = shard.make_mesh(jax.devices()[:2])
    calls = {
        "render": lambda: raytpu.render(scene, cam, CFG, backend="pallas"),
        "render_grad": lambda: raytpu.render_grad(scene, cam, CFG, target,
                                                  backend="pallas"),
        "render_sharded_pallas": lambda: shard.render_sharded_pallas(
            scene, cam, CFG, mesh=mesh),
        "make_train_step_pallas": lambda: shard.make_train_step_pallas(
            CFG, mesh),
        "accumulate": lambda: progressive.accumulate(
            scene, cam, CFG, progressive.init_state(CFG), 1,
            backend="pallas"),
    }
    with pytest.raises(ValueError, match="interpret=True"):
        calls[call]()


def test_auto_on_cpu_renders_golden():
    scene, cam = raytpu.test_world(), _cam()
    from raytpu import golden
    assert (jnp.asarray(raytpu.render(scene, cam, CFG))
            == golden.render_golden(scene, cam, CFG)).all()


@pytest.mark.parametrize("env, want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}, None),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(env, want):
    assert raytpu.compile_cache_dir(env) == want


def _cache_dir_in_fresh_process(env_cache):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_cache is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_cache
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, raytpu; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
        check=True)
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_cache", [None, "cache-from-env"])
def test_compile_cache_in_fresh_process(env_cache):
    """Importing raytpu sets the in-checkout path only when the variable
    is unset; when it is set, JAX's own reading of it stands."""
    got = _cache_dir_in_fresh_process(env_cache)
    if env_cache is None:
        assert got == os.path.join(REPO, ".jax_cache")
    else:
        assert got == env_cache
