"""Golden-image regression tests — BASELINE configs at reduced scale.

SURVEY.md §4 test-strategy item 3: golden renders for the benchmark
configurations, stored as PNGs in tests/goldens/.  These are REGRESSION
anchors, not correctness oracles (tests/test_oracle.py is the oracle):
any intentional change to shading/traversal semantics must regenerate them
(`python tests/test_golden.py regen`) and justify the diff.

Configs (BASELINE.md, miniaturized):
  g1 — textured crate, primary rays + Phong           (config 1)
  g2 — sphere + plane, spot shadow rays               (config 2)
  g3 — reflective multi-mesh scene, one mirror bounce (config 3)
  g4 — transparent sphere, refraction path            (refraction slice)
  g5 — 100k-tri reflective terrain, 256^2, 2 bounces + shadow
       (config 4's shape — the DEPTH golden: a traversal regression that
       only manifests at deep walks flips this image, and it is checked
       through BOTH the tiled XLA backend and the walk kernel in
       interpret mode)

g1-g4 render at 128^2.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest

from raytpu.config import Intersector, Quantize, RenderConfig
from raytpu.core.camera import Camera
from raytpu.io.image import read_image, write_image
from raytpu.render import render_image
from tests.scenes import crate_scene, sphere_and_plane_scene

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _cfg(**kw):
    kw.setdefault("width", 128)
    kw.setdefault("height", 128)
    kw.setdefault("intersector", Intersector.OCTREE)
    kw.setdefault("quantize", Quantize.FINAL)
    return RenderConfig(**kw)


def _cases():
    cam = Camera(position=(0.0, 16.0, 32.0), aspect=1.0)
    return {
        "g1_crate_primary": (
            crate_scene(), _cfg(max_reflections=0), cam),
        "g2_shadowed_sphere": (
            sphere_and_plane_scene(reflect=0.0, textured=True),
            _cfg(max_reflections=0), cam),
        "g3_mirror_bounce": (
            sphere_and_plane_scene(reflect=0.7, textured=True),
            _cfg(max_reflections=1), cam),
        "g4_refraction": (
            sphere_and_plane_scene(reflect=0.3, transparent=True),
            _cfg(max_reflections=2), cam),
    }


def _terrain_scene():
    """~100k-tri reflective terrain (BASELINE config 4's mesh shape)."""
    from raytpu.scene.lights import SpotLight
    from raytpu.scene.procedural import subdivided_plane
    from raytpu.scene.types import Material, Scene, SceneObject

    mesh = subdivided_plane(
        size=(40.0, 40.0),
        divisions=224,  # 2 * 224^2 = 100,352 triangles
        material=Material(reflectiveness=0.3,
                          diffuse_color=(0.7, 0.6, 0.5, 1.0)),
        height_fn=lambda x, z: 2.0 * np.sin(x * 0.7) * np.cos(z * 0.7)
        + 0.5 * np.sin(x * 3.1) * np.sin(z * 2.3),
    )
    return Scene(
        objects=[SceneObject(meshes=[mesh])],
        lights=[SpotLight(position=(0.0, 30.0, 25.0),
                          direction=(0.0, -0.7682213, -0.6401844))],
    )


def _terrain_setup():
    flat = _terrain_scene().flatten(build_octree=False, cluster_size=128)
    cfg = _cfg(width=256, height=256, max_reflections=2,
               intersector=Intersector.TILED, tile_pixels=8192)
    cam = Camera(position=(0.0, 28.0, 34.0), target=(0.0, 0.0, 0.0),
                 aspect=1.0)
    return flat, cfg, cam


def _render(scene, cfg, cam):
    flat = scene.flatten(leaf_threshold=16, max_depth=8)
    return np.asarray(render_image(flat, cfg, cam))


def _compare(name, img):
    path = os.path.join(GOLDEN_DIR, name + ".png")
    assert os.path.exists(path), (
        f"golden {name} missing — run `python tests/test_golden.py regen`"
    )
    got = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    want = read_image(path)
    # FINAL quantization makes the comparison a straight byte compare with
    # a 1-step tolerance for cross-platform fp rounding.
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"{name}: max byte diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, (
        f"{name}: {100 * (diff > 0).mean():.2f}% of bytes changed"
    )


@pytest.mark.parametrize("name", sorted(_cases()))
def test_golden(name):
    scene, cfg, cam = _cases()[name]
    _compare(name, _render(scene, cfg, cam))


@pytest.mark.parametrize("intersector",
                         [Intersector.TILED, Intersector.PALLAS])
def test_golden_terrain_depth(intersector):
    """The 256^2 / 100k-tri / 2-bounce depth golden through BOTH deep
    backends: the tiled XLA walk and the walk kernel (kernels/walk.py,
    interpret mode on CPU — the same walk/order/acceptance the GPU runs)."""
    import dataclasses

    flat, cfg, cam = _terrain_setup()
    cfg = dataclasses.replace(cfg, intersector=intersector, interpret=True)
    img = np.asarray(render_image(flat, cfg, cam))
    _compare("g5_terrain_depth", img)


def regen():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, (scene, cfg, cam) in sorted(_cases().items()):
        img = _render(scene, cfg, cam)
        write_image(os.path.join(GOLDEN_DIR, name + ".png"), img)
        print(f"wrote {name}.png (mean {img.mean():.4f})")
    flat, cfg, cam = _terrain_setup()
    img = np.asarray(render_image(flat, cfg, cam))
    write_image(os.path.join(GOLDEN_DIR, "g5_terrain_depth.png"), img)
    print(f"wrote g5_terrain_depth.png (mean {img.mean():.4f})")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        regen()
