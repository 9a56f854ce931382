"""CLI smoke tests (the L3 shell, SURVEY.md §1)."""

import json
import os

import numpy as np

from raytpu import cli


def test_render_writes_png(tmp_path):
    out = str(tmp_path / "img.png")
    rc = cli.main(["render", "--scene", "config1", "--width", "32",
                   "--height", "16", "--spp", "1", "--depth", "2",
                   "--backend", "golden", "--out", out,
                   "--log", str(tmp_path / "run.jsonl")])
    assert rc == 0
    assert os.path.exists(out)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    log = [json.loads(l) for l in open(tmp_path / "run.jsonl")]
    assert log and log[0]["rays_per_sec"] > 0


def test_render_progressive_checkpoint(tmp_path):
    out = str(tmp_path / "img.png")
    ckpt = str(tmp_path / "ck.npz")
    rc = cli.main(["render", "--scene", "test", "--width", "32",
                   "--height", "16", "--spp", "4", "--depth", "2",
                   "--progressive", "2", "--checkpoint", ckpt,
                   "--out", out])
    assert rc == 0
    assert os.path.exists(out) and os.path.exists(ckpt)
    # resume on a complete checkpoint still writes the image
    rc = cli.main(["render", "--scene", "test", "--width", "32",
                   "--height", "16", "--spp", "4", "--depth", "2",
                   "--progressive", "2", "--checkpoint", ckpt, "--resume",
                   "--out", out])
    assert rc == 0


def test_gradcheck_passes(capsys):
    rc = cli.main(["gradcheck"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["pass"] is True


def test_info(capsys):
    assert cli.main(["info"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["devices"] >= 1


def test_render_v1_fractsin_mode(tmp_path):
    """The v1 fract-sin parity mode through the CLI (golden-routed)."""
    out = str(tmp_path / "v1.png")
    rc = cli.main(["render", "--scene", "test", "--width", "24",
                   "--height", "12", "--spp", "1", "--depth", "3",
                   "--rng-mode", "v1_fractsin", "--scatter-mode", "v1",
                   "--gamma", "2.0", "--out", out])
    assert rc == 0
    assert os.path.exists(out)


def test_validate_passes(capsys):
    import json
    from raytpu.cli import main
    assert main(["validate", "--scene", "random",
                 "--width", "64", "--height", "32", "--spp", "1",
                 "--depth", "3"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["pass"] and rep["interpret_bit_identical"]
    assert any("energy-amplifying" in w for w in rep["scene_warnings"])


def test_render_v1_scene(tmp_path):
    from raytpu.cli import main
    out = tmp_path / "v1.png"
    assert main(["render", "--scene", "v1", "--width", "32",
                 "--height", "24", "--spp", "1", "--depth", "2",
                 "--scatter-mode", "v1", "--gamma", "2.0",
                 "--out", str(out)]) == 0
    assert out.exists()


def test_render_devices_sharded(tmp_path):
    """--devices N: row-slab sharded render, bit-identical to --devices 1
    (the checked-in PNG encoder is deterministic, so identical pixels
    mean identical files)."""
    from raytpu.cli import main

    outs = []
    for n in ("1", "4"):
        out = tmp_path / f"d{n}.png"
        args = ["render", "--scene", "random", "--width", "64",
                "--height", "32", "--spp", "1", "--depth", "3",
                "--devices", n, "--backend", "pallas", "--interpret",
                "--out", str(out)]
        assert main(args) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_render_devices_progressive(tmp_path):
    """--devices with --progressive: sharded batches complete the render."""
    from raytpu.cli import main
    out = tmp_path / "p.png"
    assert main(["render", "--scene", "test", "--width", "48",
                 "--height", "24", "--spp", "4", "--depth", "2",
                 "--progressive", "2", "--devices", "2", "--interpret",
                 "--out", str(out)]) == 0
    assert out.exists()
