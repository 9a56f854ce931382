"""Render the repo's golden example image (our deterministic analogue of
the reference's examples/12depth20rays.png: random_world, v2 camera,
1024x576, 20 spp, depth 12) through raytpu.render (the engine on a GPU)."""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import raytpu
from raytpu import io
from raytpu.config import REFERENCE_GOLDEN

cfg = REFERENCE_GOLDEN
scene = raytpu.random_world()
cam = raytpu.reference_camera_v2(cfg.aspect)
img = raytpu.render(scene, cam, cfg)
out = sys.argv[1] if len(sys.argv) > 1 else "examples/12depth20rays.png"
io.save_png(out, img)
print("wrote", out)
