"""raytpu CLI — render / animate / fit.

The reference's interactive shell (Game1.cs:20-431) drives the tracer with a
keyboard: Enter renders a frame, a commented-out driver renders a turntable
animation to per-frame PNGs and stitches them into an AVI
(Game1.cs:143-210), and material/scene parameters are code + content-build
settings.  This CLI is the batch equivalent:

    python -m raytpu render  --scene demo --out out.png
    python -m raytpu animate --scene demo --frames 60 --out turn.avi
    python -m raytpu fit     --scene crate --steps 200 --out fit/

Scenes are either builtin procedural names (``demo`` — the reference's
four-sphere scene, Game1.cs:98-109 — ``crate``, ``spheres``) or a path to an
.obj / .fbx file (ingested like TracerModelProcessor did at build time).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np


def _build_scene(name: str, reflect: float, transparent: bool):
    from raytpu.scene.lights import SpotLight
    from raytpu.scene.procedural import box, checker_texture, plane, uv_sphere
    from raytpu.scene.types import Material, Scene, SceneObject

    checker = checker_texture()
    ground_mat = Material(use_texture=True, texture=checker,
                          reflectiveness=0.0)
    light = SpotLight(position=(0.0, 5.0, 20.0),
                      direction=(0.0, -0.2425356, -0.9701425),
                      spot_angle=math.pi / 2)

    if name == "demo":
        # The reference's demo: 2x2 sphere grid over a ground plane with one
        # spotlight (Game1.cs:98-138).
        mat = Material(reflectiveness=reflect, transparent=transparent,
                       refraction_index=1.32,
                       diffuse_color=(0.8, 0.2, 0.2, 0.6 if transparent else 1.0))
        objs = [
            SceneObject(meshes=[uv_sphere(radius=2.0, material=mat,
                                          convex=True)],
                        position=(x, 2.0, z))
            for x in (-4.0, 4.0) for z in (-4.0, 4.0)
        ]
        objs.append(SceneObject(meshes=[plane(size=(40.0, 40.0),
                                              material=ground_mat)]))
        return Scene(objects=objs, lights=[light])
    if name == "spheres":
        mat = Material(reflectiveness=reflect,
                       diffuse_color=(0.8, 0.2, 0.2, 1.0))
        return Scene(
            objects=[
                SceneObject(meshes=[uv_sphere(radius=4.0, material=mat,
                                              convex=True)],
                            position=(0.0, 4.0, 0.0)),
                SceneObject(meshes=[plane(size=(40.0, 40.0),
                                          material=ground_mat)]),
            ],
            lights=[light],
        )
    if name == "crate":
        mat = Material(use_texture=True, texture=checker,
                       reflectiveness=reflect)
        return Scene(
            objects=[
                SceneObject(meshes=[box(size=(6.0, 6.0, 6.0), material=mat)],
                            position=(0.0, 3.0, 0.0)),
                SceneObject(meshes=[plane(size=(40.0, 40.0),
                                          material=ground_mat)]),
            ],
            lights=[light],
        )
    raise SystemExit(f"unknown builtin scene {name!r}")


def _load_scene(args):
    """Resolve ``--scene`` → (Scene, file Camera or None).

    Accepts a builtin name (demo|spheres|crate), a bare .obj/.fbx mesh
    path, or a .toml scene file — the per-asset material-params format
    (scene/sceneformat.py, the ``.contentproj`` processor-parameters
    analog)."""
    from raytpu.scene.lights import SpotLight
    from raytpu.scene.types import Material, Scene, SceneObject

    path = args.scene
    if os.path.exists(path):
        ext = os.path.splitext(path)[1].lower()
        if ext == ".toml":
            from raytpu.scene.sceneformat import load_scene_toml

            return load_scene_toml(path)
        mat = Material(reflectiveness=args.reflect,
                       diffuse_color=(0.8, 0.7, 0.6, 1.0))
        if ext == ".obj":
            from raytpu.scene.obj_loader import load_obj

            meshes = [load_obj(path, material=mat)]
        elif ext == ".fbx":
            from raytpu.scene.fbx_loader import load_fbx

            meshes = load_fbx(path, material=mat)
        else:
            raise SystemExit(f"unsupported scene file {path!r}")
        s = args.obj_scale
        obj = SceneObject(meshes=meshes, scale=(s, s, s))
        light = SpotLight(position=(0.0, 5.0, 20.0),
                          direction=(0.0, -0.2425356, -0.9701425),
                          spot_angle=math.pi / 2)
        return Scene(objects=[obj], lights=[light]), None
    return _build_scene(path, args.reflect, args.transparent), None


def _camera(args, aspect: float, scene_cam=None):
    """CLI camera: scene-file camera as the base, CLI flags override."""
    import dataclasses

    from raytpu.core.camera import Camera

    base = scene_cam or Camera()
    return dataclasses.replace(
        base,
        position=tuple(args.camera) if args.camera is not None else base.position,
        target=tuple(args.target) if args.target is not None else base.target,
        fov=args.fov if args.fov is not None else base.fov,
        aspect=aspect,
    )


def _config(args):
    from raytpu.config import Intersector, Quantize, RenderConfig, RenderMode

    return RenderConfig(
        width=args.width,
        height=args.height,
        max_reflections=args.max_reflections,
        use_multisampling=args.multisample > 0,
        multisample_quality=max(args.multisample, 1),
        intersector=Intersector[args.intersector.upper()],
        quantize=Quantize[args.quantize.upper()],
        render_mode={
            "shaded": RenderMode.SHADED,
            "normals": RenderMode.NORMALS,
            "convex": RenderMode.CONVEXFLAG,
        }[getattr(args, "render_mode", "shaded")],
    )


def _flatten(scene, args):
    need_clusters = args.intersector in ("auto", "tiled", "pallas")
    return scene.flatten(
        build_octree=args.intersector in ("auto", "octree"),
        build_clusters=need_clusters,
    )


def _dump_config(cfg, out_path: str) -> None:
    """Serialize the run config alongside the output (SURVEY.md §5)."""
    base = os.path.splitext(out_path)[0]
    with open(base + ".config.json", "w") as f:
        f.write(cfg.to_json())


def _mesh(args):
    """Device mesh from --devices (None = single device)."""
    spec = getattr(args, "devices", "1")
    if spec in (None, "1", 1):
        return None
    import jax

    from raytpu.dist.mesh import make_mesh

    devs = jax.devices()
    n = len(devs) if spec == "all" else int(spec)
    if n <= 1:
        return None
    if n > len(devs):
        raise SystemExit(
            f"--devices {spec}: only {len(devs)} devices available")
    return make_mesh(devices=devs[:n])


def _make_frame_renderer(flat, cfg, mesh, ring: bool):
    """Frame renderer for the configured execution mode.

    Parallel rendering is a first-class product path, not a library
    corner — the reference's scanline pool is its DEFAULT execution mode
    (RayTracer.cs:48-120); here ``--devices all`` shards rays over the
    mesh (dist/render.py) and ``--ring`` additionally ring-shards the
    geometry + shade tables for >HBM scenes (dist/bigscene.py).

    Scene placement (replication or ring sharding) happens ONCE here, not
    per frame — an animation re-renders, it does not re-upload."""
    if ring and mesh is None:
        raise SystemExit("--ring needs --devices > 1 (ring sharding "
                         "splits tables across a device mesh)")
    if mesh is not None and ring:
        from raytpu.dist.bigscene import (render_image_ring,
                                          shard_scene_clusters,
                                          shard_scene_shade,
                                          shard_scene_textures)

        shards = shard_scene_clusters(flat, mesh)
        shade = shard_scene_shade(flat, mesh)
        tex = shard_scene_textures(flat, mesh)  # None for textureless
        return lambda cam, **_: render_image_ring(
            flat, cfg, cam, mesh, shards=shards, shade=shade,
            texshards=tex)
    if mesh is not None:
        from raytpu.dist import render_image_sharded, replicate_scene

        rep = replicate_scene(flat, mesh)
        return lambda cam, **_: render_image_sharded(rep, cfg, cam, mesh)
    from raytpu.render import render_image

    return lambda cam, progress=None, watch_path=None: render_image(
        flat, cfg, cam, progress=progress, watch_path=watch_path)


def cmd_render(args) -> int:
    from raytpu.io.image import write_image

    scene, scene_cam = _load_scene(args)
    flat = _flatten(scene, args)
    cfg = _config(args)
    cam = _camera(args, args.width / args.height, scene_cam)
    mesh = _mesh(args)
    progress = None
    if args.progress and mesh is None:
        # The reference's on-screen "N.NN %" overlay (Game1.cs:331-344).
        progress = lambda done, total: print(
            f"\r{100.0 * done / total:6.2f} %", end="", flush=True)
    elif args.progress:
        print("(--progress is per-tile host dispatch; ignored with "
              "--devices > 1)")
    render = _make_frame_renderer(flat, cfg, mesh,
                                  getattr(args, "ring", False))
    img = render(cam, progress=progress,
                 watch_path=args.out if args.watch and mesh is None
                 else None)
    if args.progress:
        print()
    write_image(args.out, img)
    _dump_config(cfg, args.out)
    print(f"wrote {args.out} ({args.width}x{args.height}, "
          f"mean {float(np.asarray(img).mean()):.4f})")
    return 0


def cmd_animate(args) -> int:
    """Turntable render -> per-frame PNGs -> AVI (Game1.cs:143-210)."""
    from raytpu.io.avi import open_avi
    from raytpu.io.image import write_image

    scene, scene_cam = _load_scene(args)
    flat = _flatten(scene, args)
    cfg = _config(args)
    base_cam = _camera(args, args.width / args.height, scene_cam)
    render = _make_frame_renderer(flat, cfg, _mesh(args),
                                  getattr(args, "ring", False))

    frame_dir = args.frame_dir or os.path.splitext(args.out)[0] + "_frames"
    os.makedirs(frame_dir, exist_ok=True)
    _dump_config(cfg, args.out)

    cx, cy, cz = base_cam.position
    radius = math.hypot(cx, cz)
    base = math.atan2(cx, cz)

    # Per-frame PNGs double as crash checkpoints: with --resume, frames
    # already on disk are reused and only the missing ones re-render — the
    # reference's analog is re-stitching saved frame PNGs via compileVideo
    # after a crashed animation (Game1.cs:156-161, :192-210).
    from raytpu.io.image import read_image

    with open_avi(args.out, args.width, args.height, fps=args.fps,
                  codec=args.codec) as w:
        for i in range(args.frames):
            fp = os.path.join(frame_dir, f"frame_{i:04d}.png")
            if args.resume and os.path.exists(fp):
                frame = read_image(fp)
                w.add_frame(frame)
                print(f"frame {i + 1}/{args.frames} (resumed)", flush=True)
                continue
            # Orbit the camera through 2*pi like the reference advanced the
            # object rotation per completed frame (Game1.cs:163-190).
            ang = base + 2.0 * math.pi * i / args.frames
            from raytpu.core.camera import Camera

            cam = Camera(
                position=(radius * math.sin(ang), cy, radius * math.cos(ang)),
                target=base_cam.target, fov=base_cam.fov,
                aspect=args.width / args.height,
            )
            img = np.asarray(render(cam))
            frame = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            write_image(fp, img)
            w.add_frame(frame)
            print(f"frame {i + 1}/{args.frames}", flush=True)
    print(f"wrote {args.out} ({args.frames} frames @ {args.fps} fps)")
    return 0


def cmd_view(args) -> int:
    """Interactive terminal viewer (cli/interactive.py)."""
    from raytpu.cli.interactive import run_interactive

    scene, _scene_cam = _load_scene(args)
    flat = _flatten(scene, args)
    cfg = _config(args)
    flatten_kwargs = dict(
        build_octree=args.intersector in ("auto", "octree"),
        build_clusters=args.intersector in ("auto", "tiled", "pallas"),
    )
    run_interactive(flat, cfg, host_scene=scene,
                    flatten_kwargs=flatten_kwargs)
    return 0


def cmd_fit(args) -> int:
    """Inverse rendering: recover geometry/texture from a target image."""
    import jax
    import jax.numpy as jnp

    from raytpu.diff.fit import fit
    from raytpu.diff.params import GEOMETRY, TEXTURE
    from raytpu.io.image import read_image, write_image
    from raytpu.render import render_image

    if getattr(args, "ring", False):
        raise SystemExit("--ring is not supported for fit (differentiable "
                         "ring rendering is not built)")
    scene, scene_cam = _load_scene(args)
    flat = _flatten(scene, args)
    cfg = _config(args)
    cam = _camera(args, args.width / args.height, scene_cam)

    fields = ()
    if "geometry" in args.optimize:
        fields += GEOMETRY
    if "texture" in args.optimize:
        fields += TEXTURE

    if args.target_image:
        target = jnp.asarray(read_image(args.target_image),
                             jnp.float32) / 255.0
    else:
        # Self-target demo: the unperturbed render is the target; the fit
        # starts from a perturbed copy of the trainable fields and must
        # recover it (BASELINE config 4's shape).
        target = render_image(flat, cfg, cam)
        key = jax.random.PRNGKey(0)
        perturb = {}
        for f in fields:
            a = getattr(flat, f)
            key, sub = jax.random.split(key)
            perturb[f] = a + 0.02 * jax.random.normal(sub, a.shape, a.dtype)
        flat = flat.replace(**perturb)

    os.makedirs(args.out, exist_ok=True)
    fitted, _params, losses = fit(
        flat, cfg, cam, target, fields=fields, steps=args.steps,
        learning_rate=args.lr, checkpoint_dir=args.out,
        checkpoint_every=max(args.steps // 4, 1),
        mesh=_mesh(args),
    )
    final = render_image(fitted, cfg, cam)
    write_image(os.path.join(args.out, "final.png"), final)
    write_image(os.path.join(args.out, "target.png"), target)
    print(f"fit done: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({len(losses)} steps); outputs in {args.out}/")
    return 0


def _add_common(p):
    p.add_argument("--scene", default="demo",
                   help="builtin name (demo|spheres|crate) or .obj/.fbx path")
    p.add_argument("--out", default="out.png")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--max-reflections", type=int, default=8,
                   help="reference default 8 (Game1.cs:126)")
    p.add_argument("--multisample", type=int, default=0,
                   help="adaptive supersampling quality (0 = off)")
    p.add_argument("--intersector", default="auto",
                   choices=("auto", "octree", "brute", "tiled", "pallas"))
    p.add_argument("--quantize", default="final",
                   choices=("none", "final", "bounce"),
                   help="byte quantization: every bounce (the reference's "
                        "Color returns), the final write, or none (HDR)")
    p.add_argument("--camera", type=float, nargs=3, default=None,
                   help="default (0, 16, 32), the reference's (Game1.cs:111);"
                        " a .toml scene's camera is used unless overridden")
    p.add_argument("--look-at", dest="target", type=float, nargs=3,
                   default=None)
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--reflect", type=float, default=0.5)
    p.add_argument("--transparent", action="store_true")
    p.add_argument("--obj-scale", type=float, default=1.0)
    p.add_argument("--progress", action="store_true",
                   help="print percent progress (Game1.cs:331-344 overlay)")
    p.add_argument("--devices", default="1",
                   help="device parallelism: a count, or 'all' — shards "
                        "rays over a 1-D device mesh (dist/render.py; the "
                        "scanline-pool analog, RayTracer.cs:48-120)")
    p.add_argument("--ring", action="store_true",
                   help="with --devices > 1: ring-shard the geometry and "
                        "shade tables across devices for scenes larger "
                        "than one device's HBM (dist/bigscene.py)")
    p.add_argument("--render-mode", default="shaded",
                   choices=("shaded", "normals", "convex"),
                   help="diagnostic channels (RayTracer.cs:563-566 "
                        "DEBUG_NORMALS / DEBUG_CONVEXFLAG)")


def main(argv=None) -> int:
    from raytpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    ap = argparse.ArgumentParser(prog="raytpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one frame to PNG")
    _add_common(pr)
    pr.add_argument("--watch", action="store_true",
                    help="write the PNG progressively as tiles finish "
                         "(watch the frame fill in; Game1.cs:389-416)")

    pa = sub.add_parser("animate", help="turntable animation -> AVI")
    _add_common(pa)
    pa.add_argument("--frames", type=int, default=60)
    pa.add_argument("--fps", type=float, default=30.0,
                    help="reference default (Game1.cs:194)")
    pa.add_argument("--codec", default="DIB ", choices=("DIB ", "MJPG"),
                    help='"DIB " uncompressed (default) or "MJPG" (needs '
                         'PIL)')
    pa.add_argument("--frame-dir", default=None)
    pa.add_argument("--resume", action="store_true",
                    help="reuse frame PNGs already in --frame-dir")
    pa.set_defaults(out="turntable.avi")

    pv = sub.add_parser("view", help="interactive terminal viewer "
                                     "(WASD camera, Enter traces — the "
                                     "Game1 keyboard shell analog)")
    _add_common(pv)

    pf = sub.add_parser("fit", help="inverse-rendering optimization")
    _add_common(pf)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--optimize", default="geometry,texture",
                    help="comma list: geometry,texture")
    pf.set_defaults(out="fit_out")
    pf.add_argument("--target-image", default=None,
                    help="target PNG (default: self-target recovery demo)")

    args = ap.parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "animate":
        return cmd_animate(args)
    if args.cmd == "view":
        return cmd_view(args)
    if args.cmd == "fit":
        return cmd_fit(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
