"""Reference-asset golden renders (BASELINE cfg 1).

These anchor the validation loop on the reference's OWN content:

  ref1_crate_freecrate — the crate mesh (Crate_Fragile.FBX) textured with
      Free_crate/Diffuse.bmp, the exact content BASELINE config 1 names,
      at 128x128 primary+shadow (assets/crate_freecrate.toml).
  ref2_contentproj_trio — Sphere.fbx / torus.fbx / plane.fbx ("ground")
      with their shipped .contentproj TracerModelProcessor parameters
      (Sphere: Transparent, RefractionIndex 1.32, Reflectiveness 0.7 —
      RayTraceProjectContent.contentproj:90-226), at 128x128 with two
      bounces (assets/reference_demo.toml).

Skipped when the reference corpus is not mounted at /root/reference, like
tests/test_loaders.py.  Regenerate: `python tests/test_golden_ref.py regen`.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest

from raytpu.config import Intersector, Quantize, RenderConfig
from raytpu.io.image import read_image, write_image
from raytpu.render import render_image
from raytpu.scene.sceneformat import load_scene_toml

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
REF = "/root/reference"

needs_ref = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference assets not present"
)


def _cases():
    return {
        "ref1_crate_freecrate": (
            os.path.join(ASSETS, "crate_freecrate.toml"),
            RenderConfig(width=128, height=128, max_reflections=0,
                         intersector=Intersector.TILED,
                         quantize=Quantize.FINAL, tile_pixels=16384)),
        "ref2_contentproj_trio": (
            os.path.join(ASSETS, "reference_demo.toml"),
            RenderConfig(width=128, height=128, max_reflections=2,
                         intersector=Intersector.TILED,
                         quantize=Quantize.FINAL, tile_pixels=16384)),
    }


def _render(toml_path, cfg):
    scene, cam = load_scene_toml(toml_path)
    flat = scene.flatten(build_octree=False, build_clusters=True,
                         cluster_size=128)
    return np.asarray(render_image(flat, cfg, cam))


@needs_ref
@pytest.mark.parametrize("name", sorted(_cases()))
def test_reference_golden(name):
    toml_path, cfg = _cases()[name]
    path = os.path.join(GOLDEN_DIR, name + ".png")
    assert os.path.exists(path), (
        f"golden {name} missing — run `python tests/test_golden_ref.py "
        f"regen` with the reference mounted"
    )
    img = _render(toml_path, cfg)
    got = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    want = read_image(path)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"{name}: max byte diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, (
        f"{name}: {100 * (diff > 0).mean():.2f}% of bytes changed"
    )


@needs_ref
def test_cli_renders_reference_toml(tmp_path):
    """`raytpu render --scene <toml pointing at reference FBX>` produces a
    sane image (the product surface covers the reference corpus)."""
    from raytpu.cli.main import main

    out = str(tmp_path / "demo.png")
    rc = main([
        "render", "--scene", os.path.join(ASSETS, "reference_demo.toml"),
        "--out", out, "--width", "48", "--height", "48",
        "--max-reflections", "1", "--intersector", "tiled",
    ])
    assert rc == 0 and os.path.exists(out)
    img = read_image(out)
    assert img.shape == (48, 48, 3)
    assert (img.max(axis=-1) > 0).mean() > 0.2, "image mostly black"


def regen():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, (toml_path, cfg) in sorted(_cases().items()):
        img = _render(toml_path, cfg)
        write_image(os.path.join(GOLDEN_DIR, name + ".png"), img)
        print(f"wrote {name}.png (mean {img.mean():.4f}, "
              f"nonblack {(img.max(-1) > 0).mean():.3f})")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        regen()
