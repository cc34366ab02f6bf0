"""Smoke test of raytpu on the GPU: the main paths once, each checked.

    python chip_smoke.py          # one card: phases (a)-(e)
    python chip_smoke.py --four   # the four-card paths only, on 4 cards

One process does everything; the CLI is called in-process.  Each phase
prints one line with its numbers; any failed check raises, so the exit code
is non-zero and the last line is not printed.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Phases on one card:

(a) the card's name and power limit, and the compiled frame program's
    memory analysis (the reference demo at 512^2, 8 bounces);
(b) ``render --scene assets/demo.toml`` through the CLI at 512^2 with 8
    bounces, byte-quantized at every bounce, against the NumPy oracle
    (ref_oracle) on 256 seeded pixels: >= 99% exact, every mismatch <= 3/255
    (tests/test_oracle.py's criterion); the demo frame timed with the walk
    kernel and with TILED;
(c) the 1M-triangle bench scene at 1024^2: the walk kernel's hits against
    TILED on every primary ray and against BRUTE on 4,096 seeded rays; the
    primary + shadow frame, the XLA front half and the kernel timed;
(d) three GEOMETRY and three TEXTURE fit steps (diff/fit.make_fit_step) at
    512^2 on the bench scene: finite losses, and gradients equal to those of
    the same steps over TILED;
(e) ``animate --frames 4`` through the CLI, writing an AVI.

Phases on four cards (a 1-D mesh, as the CLI's ``--devices all`` builds):
the ray-sharded 1080p demo frame through the CLI against the one-card
image, the ring-sharded bench scene (``render_image_ring``) against the
one-card image, and one distributed fit step's gradients against the
one-card step's.

Outputs (PNG, AVI) go to ``chiprun_out/smoke/`` in the checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import jax
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")
DEMO = os.path.join(ROOT, "assets", "demo.toml")

#: Sizes: the reference demo's frame, the bench scene and its frame, the
#: fit frame, and the sharded frame (a rehearsal may shrink them).
DEMO_RES = 512
BENCH_TRIS = 1_000_000
BENCH_RES = 1024
FIT_RES = 512
HD = (1920, 1080)

#: Hits of the walk kernel against TILED or BRUTE: the triangle ids agree
#: except at ties — a ray through an edge two triangles share, where the
#: kernel's rounding (its own summation order) may pick the other one.  A
#: differing ray must hit in both with distances within T_RTOL, and at most
#: TIE_FRACTION of the rays may differ.
T_RTOL = 1e-5
TIE_FRACTION = 1e-2
#: Frames rendered over the walk kernel and TILED: a tie may move a pixel, so
#: at most PIXEL_FRACTION of the pixels may differ by more than 1e-4.
PIXEL_FRACTION = 1e-2
#: Relative tolerance on fit-step gradients between the walk kernel and
#: TILED: with equal hits only the order of the gradient scatter-adds
#: (atomics on the card) differs.
GRAD_RTOL = 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def compare_hits(a, b, what):
    """Triangle ids of two queries agree up to ties (see TIE_FRACTION);
    returns (differing rays, max relative distance difference on hits)."""
    ta, tb = np.asarray(a.tri), np.asarray(b.tri)
    da, db = np.asarray(a.t), np.asarray(b.t)
    check(np.array_equal(ta >= 0, tb >= 0), f"{what}: hit masks differ")
    m = tb >= 0
    rel = np.abs(da - db)[m] / np.maximum(db[m], 1e-30)
    t_rel = float(rel.max()) if m.any() else 0.0
    differ = int((ta != tb).sum())
    check(t_rel <= T_RTOL, f"{what}: t rel diff {t_rel:.3e}")
    check(differ <= TIE_FRACTION * ta.size,
          f"{what}: {differ} of {ta.size} rays hit another triangle")
    return differ, t_rel


def median_time(fn, *args, reps: int = 5) -> float:
    """Median wall seconds of ``fn(*args)`` (compiled first), synced with
    ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase(name: str, **numbers) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def demo_scene():
    from raytpu.scene.sceneformat import load_scene_toml

    scene, cam = load_scene_toml(DEMO)
    return scene.flatten(), cam


def frame_fn(cfg):
    from raytpu.render.wavefront import render_rays

    return jax.jit(lambda s, o, d: render_rays(s, cfg, o, d))


def block_rays(camera, cfg):
    from raytpu.core.camera import camera_rays
    from raytpu.render.wavefront import block_order_perm

    o, d = camera_rays(camera, cfg.width, cfg.height)
    perm = block_order_perm(cfg.width, cfg.height,
                            max(1, int(cfg.cull_tile ** 0.5)))
    return jax.device_put(o[perm]), jax.device_put(d[perm])


@functools.lru_cache(maxsize=2)
def bench_setup(textured=False):
    """The bench scene (bench.build_scene), flattened once per process."""
    from bench import build_scene
    from raytpu.core.camera import Camera

    scene, true_tris = build_scene(BENCH_TRIS, textured=textured)
    cam = Camera(position=(0.0, 28.0, 34.0), target=(0.0, 0.0, 0.0),
                 aspect=1.0)
    return scene.flatten(build_octree=False), cam, true_tris


# --- one card ---------------------------------------------------------------


def phase_a():
    from raytpu.config import Intersector, RenderConfig

    flat, cam = demo_scene()
    cfg = RenderConfig(width=DEMO_RES, height=DEMO_RES, max_reflections=8,
                       intersector=Intersector.AUTO)
    o, d = block_rays(dataclasses.replace(cam, aspect=1.0), cfg)
    mem = frame_fn(cfg).lower(flat, o, d).compile().memory_analysis()
    phase("a: frame program", scene=f"demo {DEMO_RES}^2 8 bounces",
          argument_bytes=mem.argument_size_in_bytes,
          output_bytes=mem.output_size_in_bytes,
          temp_bytes=mem.temp_size_in_bytes,
          generated_code_bytes=mem.generated_code_size_in_bytes)


def phase_b():
    from raytpu.cli.main import main
    from raytpu.config import Intersector, Quantize, RenderConfig
    from raytpu.core.camera import camera_rays
    from raytpu.io.image import read_image
    from raytpu.ref_oracle.tracer import OracleScene, cast_ray

    out = os.path.join(OUT, "demo.png")
    t0 = time.perf_counter()
    check(main(["render", "--scene", DEMO, "--out", out,
                "--width", str(DEMO_RES), "--height", str(DEMO_RES),
                "--max-reflections", "8", "--quantize", "bounce"]) == 0,
          "CLI render exit code")
    cli_s = time.perf_counter() - t0
    got = read_image(out).astype(np.float32).reshape(-1, 3) / 255.0

    flat, cam = demo_scene()
    cam = dataclasses.replace(cam, aspect=1.0)
    cfg = RenderConfig(width=DEMO_RES, height=DEMO_RES, max_reflections=8,
                       quantize=Quantize.BOUNCE)
    o, d = (np.asarray(a) for a in camera_rays(cam, DEMO_RES, DEMO_RES))
    sc = OracleScene.from_flat(flat)
    idx = np.random.default_rng(0).choice(DEMO_RES ** 2, 256, replace=False)
    want = np.stack([cast_ray(sc, cfg, o[i], d[i]) for i in idx])
    diff = np.abs(got[idx] - want)
    exact = float(np.all(diff < 0.5 / 255.0, axis=-1).mean())
    check(exact >= 0.99, f"demo vs oracle: {exact:.4f} of pixels exact")
    check(float(diff.max()) <= 3.0 / 255.0 + 1e-6,
          f"demo vs oracle: max diff {float(diff.max()) * 255:.2f}/255")

    times = {}
    for it in (Intersector.PALLAS, Intersector.TILED):
        c = dataclasses.replace(cfg, intersector=it)
        oo, dd = block_rays(cam, c)
        times[it.name] = median_time(frame_fn(c), flat, oo, dd)
    phase("b: demo render", cli_wall_s=round(cli_s, 3),
          oracle_pixels=len(idx), exact_fraction=exact,
          max_diff_255=round(float(diff.max()) * 255, 3),
          frame_ms_walk=round(times["PALLAS"] * 1e3, 3),
          frame_ms_tiled=round(times["TILED"] * 1e3, 3))


def phase_c():
    from raytpu.accel.traverse import nearest_hit, nearest_hit_brute
    from raytpu.config import Intersector, Quantize, RenderConfig
    from raytpu.kernels.walk import WALK_TILE, front_half, walk_tiles

    flat, cam, n_tris = bench_setup()
    cfg = RenderConfig(width=BENCH_RES, height=BENCH_RES, max_reflections=0,
                       tile_pixels=BENCH_RES ** 2, quantize=Quantize.NONE)
    o, d = block_rays(cam, cfg)

    def query(it):
        return jax.jit(lambda s, o, d: nearest_hit(
            s, o, d, intersector=it, cull_tile=cfg.cull_tile))

    hw = query(Intersector.PALLAS)(flat, o, d)
    ht = query(Intersector.TILED)(flat, o, d)
    mism, t_rel = compare_hits(hw, ht, "walk vs TILED")

    sel = np.random.default_rng(1).choice(o.shape[0], 4096, replace=False)
    hb = jax.jit(lambda s, o, d: nearest_hit_brute(s, o, d))(
        flat, o[sel], d[sel])
    hws = jax.tree.map(lambda a: np.asarray(a)[sel], hw)
    b_mism, b_rel = compare_hits(hws, hb, "walk vs BRUTE")

    imgs, times = {}, {}
    for it in (Intersector.PALLAS, Intersector.TILED):
        f = frame_fn(dataclasses.replace(cfg, intersector=it))
        imgs[it.name] = np.asarray(f(flat, o, d))
        times[it.name] = median_time(f, flat, o, d)
    px = np.abs(imgs["PALLAS"] - imgs["TILED"]).max(axis=-1)
    moved = float((px > 1e-4).mean())
    check(moved <= PIXEL_FRACTION, f"walk vs TILED frame: {moved:.5f} of "
          f"pixels differ")

    front = jax.jit(lambda s, o, d: front_half(s, o, d,
                                               tile_size=cfg.cull_tile))
    t_front = median_time(front, flat, o, d)
    cand, keys, counts, rays = front(flat, o, d)
    cl = flat.clusters
    geo = jax.numpy.concatenate([cl["tri_v1"], cl["tri_e1"], cl["tri_e2"],
                                 cl["tri_snormal"]], axis=1).T
    kern = jax.jit(lambda *a: walk_tiles(
        *a, csize=cl["tri_v1"].shape[0] // cl["cluster_min"].shape[0],
        walk_tile=WALK_TILE, cull=True, any_hit=False, has_ignore=False))
    t_kernel = median_time(kern, geo, cl["tri_id"], cl["tri_mesh"], cand,
                           keys, counts, rays)
    phase(f"c: bench scene {BENCH_RES}^2", tris=n_tris,
          walk_vs_tiled_tri_mismatch=mism, t_rel_max=t_rel,
          walk_vs_brute_mismatch=b_mism, brute_t_rel_max=b_rel,
          frame_pixels_moved=moved, frame_max_diff=float(px.max()),
          hit_fraction=round(float((np.asarray(ht.tri) >= 0).mean()), 4),
          frame_ms_walk=round(times["PALLAS"] * 1e3, 3),
          frame_ms_tiled=round(times["TILED"] * 1e3, 3),
          primary_front_half_ms=round(t_front * 1e3, 3),
          primary_walk_kernel_ms=round(t_kernel * 1e3, 3),
          mean_candidates_per_tile=round(float(np.asarray(counts).mean()), 2))


def fit_grads(flat, cfg, fields, o, d, target, mesh=None, steps=3):
    """Run ``steps`` SGD fit steps; returns (losses, first step's gradient
    as one (rows, 3) array: a row per triangle or texel)."""
    import optax

    from raytpu.diff.fit import make_fit_step
    from raytpu.diff.params import extract_params

    # The first transformation keeps the step's gradient as its state.
    record = optax.GradientTransformation(
        init=lambda p: jax.tree.map(jax.numpy.zeros_like, p),
        update=lambda g, s, p=None: (g, g))
    opt = optax.chain(record, optax.sgd(1e-2))
    params = extract_params(flat, fields)
    state = opt.init(params)
    step = make_fit_step(flat, cfg, opt, mesh=mesh, fields=fields)
    losses, grad = [], None
    for i in range(steps):
        params, state, loss = step(params, state, o, d, target)
        losses.append(float(loss))
        if i == 0:
            grad = np.concatenate([np.asarray(state[0][k]).reshape(-1, 3)
                                   for k in sorted(state[0])])
    return losses, grad


def compare_grads(gw, gt, what):
    """Gradients agree row by row (a row per triangle or texel) to
    GRAD_RTOL, except rows that a tie hands to the neighbouring triangle or
    whose contributions nearly cancel (there the order of the atomic sums
    shows): at most TIE_FRACTION of the nonzero rows.  Returns (differing
    rows, nonzero rows, relative L2 difference over the other rows)."""
    scale = float(np.abs(gt).max())
    check(scale > 0, f"{what}: zero gradient")
    row_diff = np.abs(gw - gt).max(axis=1)
    row_mag = np.maximum(np.abs(gw).max(axis=1), np.abs(gt).max(axis=1))
    bad = row_diff > GRAD_RTOL * row_mag + 1e-6 * scale
    nonzero = int((row_mag > 0).sum())
    check(int(bad.sum()) <= TIE_FRACTION * nonzero,
          f"{what}: {int(bad.sum())} of {nonzero} gradient rows differ")
    keep = ~bad
    rel = float(np.linalg.norm(gw[keep] - gt[keep])
                / max(np.linalg.norm(gt[keep]), 1e-30))
    return int(bad.sum()), nonzero, rel


def phase_d():
    from raytpu.config import Intersector, Quantize, RenderConfig
    from raytpu.config import TextureFiltering
    from raytpu.diff.params import GEOMETRY, TEXTURE

    numbers = {}
    for name, fields, textured in (("geometry", GEOMETRY, False),
                                   ("texture", TEXTURE, True)):
        flat, cam, _ = bench_setup(textured=textured)
        cfg = RenderConfig(width=FIT_RES, height=FIT_RES, max_reflections=0,
                           tile_pixels=FIT_RES ** 2, quantize=Quantize.NONE,
                           filtering=TextureFiltering.BILINEAR)
        o, d = block_rays(cam, cfg)
        target = jax.numpy.zeros((o.shape[0], 3), jax.numpy.float32)
        res = {}
        for it in (Intersector.PALLAS, Intersector.TILED):
            t0 = time.perf_counter()
            res[it.name] = fit_grads(flat, dataclasses.replace(
                cfg, intersector=it), fields, o, d, target)
            numbers[f"{name}_{it.name.lower()}_wall_s"] = round(
                time.perf_counter() - t0, 2)
        (lw, gw), (lt, gt) = res["PALLAS"], res["TILED"]
        check(np.all(np.isfinite(lw)) and np.all(np.isfinite(lt)),
              f"{name} fit: non-finite loss")
        rows, nonzero, rel = compare_grads(gw, gt, f"{name} fit")
        check(rel <= GRAD_RTOL, f"{name} fit: gradient rel diff {rel:.3e}")
        numbers[f"{name}_losses_walk"] = [round(x, 8) for x in lw]
        numbers[f"{name}_losses_tiled"] = [round(x, 8) for x in lt]
        numbers[f"{name}_differing_rows"] = f"{rows}/{nonzero}"
        numbers[f"{name}_grad_rel_diff"] = rel
    phase(f"d: fit steps {FIT_RES}^2 on the bench scene", **numbers)


def phase_e():
    from raytpu.cli.main import main

    out = os.path.join(OUT, "turntable.avi")
    t0 = time.perf_counter()
    check(main(["animate", "--scene", DEMO, "--frames", "4", "--out", out,
                "--width", str(DEMO_RES), "--height", str(DEMO_RES),
                "--frame-dir", os.path.join(OUT, "frames")]) == 0,
          "CLI animate exit code")
    wall = time.perf_counter() - t0
    with open(out, "rb") as f:
        head = f.read(64)
    frames = int.from_bytes(head[48:52], "little")  # avih dwTotalFrames
    check(head[:4] == b"RIFF" and head[8:12] == b"AVI ", "AVI header")
    check(frames == 4, f"AVI holds {frames} frames")
    phase("e: animate", frames=frames, bytes=os.path.getsize(out),
          wall_s=round(wall, 2))


# --- four cards -------------------------------------------------------------


def compare_images(a, b, what):
    """At most PIXEL_FRACTION of the pixels differ by more than 1e-4 (a
    tie, or on the ring a cross-shard tie, moves a pixel); returns (moved
    fraction, max difference)."""
    px = np.abs(np.asarray(a, np.float32)
                - np.asarray(b, np.float32)).max(axis=-1)
    moved = float((px > 1e-4).mean())
    check(moved <= PIXEL_FRACTION, f"{what}: {moved:.5f} of pixels differ")
    return moved, float(px.max())


def four_sharded_frame():
    from raytpu.cli.main import main
    from raytpu.io.image import read_image

    outs = {}
    for devices in ("all", "1"):
        out = os.path.join(OUT, f"demo_hd_devices_{devices}.png")
        t0 = time.perf_counter()
        check(main(["render", "--scene", DEMO, "--out", out,
                    "--width", str(HD[0]), "--height", str(HD[1]),
                    "--devices", devices]) == 0, "CLI render exit code")
        outs[devices] = (read_image(out), time.perf_counter() - t0)
    same, mx = compare_images(outs["all"][0], outs["1"][0],
                              "sharded 1080p vs one card")
    phase(f"4a: ray-sharded {HD[0]}x{HD[1]} demo", pixels_moved=same,
          max_diff=mx,
          cli_wall_s_four=round(outs["all"][1], 2),
          cli_wall_s_one=round(outs["1"][1], 2))


def four_ring(mesh):
    from raytpu.config import Quantize, RenderConfig
    from raytpu.dist.bigscene import (render_image_ring, shard_scene_clusters,
                                      shard_scene_shade)
    from raytpu.render import render_image

    flat, cam, n_tris = bench_setup()
    cfg = RenderConfig(width=BENCH_RES, height=BENCH_RES, max_reflections=0,
                       quantize=Quantize.FINAL)
    shards = shard_scene_clusters(flat, mesh)
    shade = shard_scene_shade(flat, mesh)
    ring = lambda: render_image_ring(flat, cfg, cam, mesh, shards=shards,
                                     shade=shade)
    one = lambda: render_image(flat, cfg, cam)
    a, b = np.asarray(ring()), np.asarray(one())
    same, mx = compare_images(a, b, "ring vs one card")
    phase(f"4b: ring-sharded bench scene {BENCH_RES}^2", tris=n_tris,
          pixels_moved=same, max_diff=mx,
          frame_s_ring=round(median_time(ring, reps=3), 4),
          frame_s_one=round(median_time(one, reps=3), 4))


def four_fit(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from raytpu.config import Quantize, RenderConfig
    from raytpu.diff.params import GEOMETRY

    flat, cam, _ = bench_setup()
    cfg = RenderConfig(width=FIT_RES, height=FIT_RES, max_reflections=0,
                       tile_pixels=FIT_RES ** 2 // 4, quantize=Quantize.NONE)
    o, d = block_rays(cam, cfg)
    target = jax.numpy.zeros((o.shape[0], 3), jax.numpy.float32)
    shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    put = lambda a: jax.device_put(a, shard)
    l4, g4 = fit_grads(flat, cfg, GEOMETRY, put(o), put(d), put(target),
                       mesh=mesh, steps=1)
    l1, g1 = fit_grads(flat, cfg, GEOMETRY, o, d, target, steps=1)
    rows, nonzero, rel = compare_grads(g4, g1, "four-card fit")
    check(rel <= GRAD_RTOL, f"four-card fit: gradient rel diff {rel:.3e}")
    phase(f"4c: distributed GEOMETRY fit step {FIT_RES}^2", loss_four=l4[0],
          loss_one=l1[0], differing_rows=f"{rows}/{nonzero}",
          grad_rel_diff=rel)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases (needs 4 GPUs)")
    args = ap.parse_args()

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"chip_smoke.py needs {want} GPUs; JAX found {len(devs)}",
              file=sys.stderr)
        return 2

    from raytpu.utils.backend import card_name_and_power_limit
    from raytpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    print(card_name_and_power_limit(), flush=True)
    t0 = time.perf_counter()
    if args.four:
        from raytpu.dist.mesh import make_mesh

        mesh = make_mesh(devices=devs[:4])
        four_sharded_frame()
        four_ring(mesh)
        four_fit(mesh)
    else:
        phase_a()
        phase_b()
        phase_c()
        phase_d()
        phase_e()
    phase("total", wall_s=round(time.perf_counter() - t0, 1))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
