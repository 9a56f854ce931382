"""chip_smoke.py's phases at tiny sizes, the engine in the interpreter.

The phases are plain functions; only ``main`` demands a GPU.  Here they
run on the CPU, where the interpreted engine is bit-identical to golden,
so every tolerance they check holds with room to spare."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import raytpu
from raytpu.config import RenderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()
TINY = RenderConfig(width=16, height=8, spp=2, depth=3)


def test_phase_precision_interpret():
    out = cs.phase_precision(n=2048, interpret=True)
    assert set(out) == {"div", "sqrt", "rsqrt", "exp", "log", "sin", "cos"}
    # the interpreter is XLA on the CPU: both columns are XLA's
    for v in out.values():
        assert v["triton_max_ulp"] == v["xla_max_ulp"]


@pytest.mark.parametrize("scene_name", ["random", "final"])
def test_phase_forward(scene_name):
    scene = (raytpu.random_world(seed=2, half_extent=2)
             if scene_name == "random" else raytpu.final_world(n=40))
    st = cs.phase_forward(TINY, scene, cs.camera(TINY), scene_name,
                          interpret=True)
    assert st["max_abs"] == 0.0


def test_phase_forward_depth1_is_strict():
    """The depth-1 pass (camera rays, one hit, sky) is held to the tight
    bound; interpret mode meets it exactly."""
    st = cs.phase_forward_depth1(TINY, raytpu.test_world(),
                                 cs.camera(TINY), "depth1", interpret=True)
    assert st["outlier_frac"] == 0.0


def test_phase_control():
    st = cs.phase_control(TINY, raytpu.test_world(), cs.camera(TINY),
                          interpret=True)
    assert st["outlier_frac"] == 0.0


def test_phase_gradients():
    cfg = TINY.replace(spp=1)
    out = cs.phase_gradients(cfg, raytpu.config2_world(), cs.camera(cfg),
                             interpret=True)
    assert all(v <= cs.GRAD_RTOL for k, v in out.items() if k != "loss")


def test_phase_grad_finite():
    out = cs.phase_grad_finite(TINY, raytpu.final_world(n=40),
                               cs.camera(TINY), interpret=True)
    assert np.isfinite(out["loss"])


def test_phase_adam():
    losses = cs.phase_adam(size=(32, 16), interpret=True)
    assert len(losses) == 3 and losses[-1] < losses[0]


def test_phase_progressive():
    out = cs.phase_progressive(TINY, raytpu.config2_world(),
                               cs.camera(TINY), batch=1, interpret=True)
    assert out["bit_equal"]


def test_phase_cli():
    cs.phase_cli(size=(12, 6), interpret=True)


def test_phase_sharded_on_four_cpu_devices():
    cfg = RenderConfig(width=12, height=10, spp=1, depth=2)
    out = cs.phase_sharded(jax.devices()[:4], cfg, raytpu.test_world(),
                           cs.camera(cfg), cfg, raytpu.test_world(),
                           interpret=True)
    assert out["render_bit_equal"] and out["progressive_bit_equal"]


def test_check_image_rejects_out_of_tolerance():
    ref = np.zeros((4, 4, 3), np.float32)
    img = ref.copy()
    img[0, 0, 0] = 1.0
    with pytest.raises(AssertionError):
        cs.check_image("x", img, ref, max_frac=0.0)


def test_check_image_rejects_non_finite():
    ref = np.zeros((2, 2, 3), np.float32)
    img = ref.copy()
    img[1, 1, 1] = np.nan
    with pytest.raises(AssertionError):
        cs.check_image("x", img, ref)


def test_main_refuses_the_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert "ok" not in capsys.readouterr().out


def _run_alone(tmp_path, env_extra=None):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_script_alone_fails(tmp_path):
    """Without the package beside it the script fails and prints no
    result line."""
    out = _run_alone(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_script_without_gpu_fails(tmp_path):
    out = subprocess.run([sys.executable, SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]
    with pytest.raises(json.JSONDecodeError):
        json.loads(lines[-1] if lines else "")
