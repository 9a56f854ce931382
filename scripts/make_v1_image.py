"""Render the faithful v1 example image: the v1 pixel-shader app's own
scene (Shader_RT.fx:300-335 via raytpu.v1_world), camera (640x480, vfov
20, aperture 0.1, focus 10 — DXRayTrace.cpp:196-223), 1 spp, depth 25,
sqrt gamma, and the generation's literal fract-sin RNG with its by-value
randState defect (rng_mode="v1_fractsin", golden-path only by design).

Runs on CPU (the parity mode is golden-only; no GPU needed):
    python scripts/make_v1_image.py [out.png]
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_platforms", "cpu")  # before any jax op
import raytpu
from raytpu import io
from raytpu.config import REFERENCE_V1_FAITHFUL

cfg = REFERENCE_V1_FAITHFUL
scene = raytpu.v1_world()
cam = raytpu.reference_camera_v1()
img = raytpu.render(scene, cam, cfg, backend="golden")
out = sys.argv[1] if len(sys.argv) > 1 else "examples/v1_faithful_640x480.png"
io.save_png(out, img)
print("wrote", out)
