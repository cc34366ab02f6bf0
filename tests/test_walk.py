"""The walk kernel (kernels/walk.py) and the rules that choose it.

The kernel compiles for the GPU; here it runs in the Pallas interpreter
(``interpret=True``) and is checked against BRUTE over a property matrix of
query kinds, culling, bounds, ignore ids, non-finite rays, tile and cluster
sizes.  The platform tests check that nothing chooses the interpreter or
another backend silently.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytpu.accel.traverse import Hit, nearest_hit, nearest_hit_brute
from raytpu.config import Intersector
from raytpu.kernels.walk import nearest_hit_walk
from tests.scenes import sphere_and_plane_scene


@pytest.fixture(scope="module")
def scenes():
    """Flattened test scene per cluster size (12 is not a power of two)."""
    return {cs: sphere_and_plane_scene().flatten(build_octree=False,
                                                 cluster_size=cs)
            for cs in (16, 12, 4)}


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


# (query, cull, bounded, ignore, nonfinite, cull tile, walk tile, cluster
# size, rays).  Ray counts of 40 and 24 leave a padded last tile.
_MATRIX = [
    ("nearest", True, False, None, False, 32, 32, 16, 64),
    ("nearest", False, False, None, False, 32, 32, 16, 64),
    ("nearest", "reverse", False, None, False, 32, 32, 16, 64),
    ("nearest", True, True, None, False, 32, 32, 16, 64),
    ("nearest", False, True, None, False, 32, 16, 16, 64),
    ("nearest", "reverse", True, None, False, 16, 8, 16, 40),
    ("nearest", True, False, "tri", False, 32, 32, 16, 64),
    ("nearest", True, False, "mesh", False, 32, 16, 16, 40),
    ("nearest", False, False, "tri", True, 16, 16, 16, 40),
    ("nearest", True, True, "mesh", True, 32, 8, 16, 40),
    ("nearest", True, False, None, True, 32, 32, 16, 64),
    ("nearest", True, False, None, False, 16, 8, 12, 40),
    ("nearest", False, True, "tri", False, 32, 32, 12, 64),
    ("nearest", "reverse", False, "mesh", True, 32, 16, 12, 24),
    ("nearest", True, True, None, False, 8, 8, 4, 24),
    ("nearest", True, False, "tri", True, 16, 16, 4, 40),
    ("nearest", False, False, None, False, 32, 8, 4, 64),
    ("nearest", True, True, "tri", False, 16, 16, 12, 24),
    ("any_hit", True, True, None, False, 32, 32, 16, 64),
    ("any_hit", False, True, None, False, 32, 16, 16, 64),
    ("any_hit", "reverse", True, None, False, 32, 32, 16, 40),
    ("any_hit", True, False, None, False, 32, 32, 16, 64),
    ("any_hit", True, True, "tri", False, 16, 8, 16, 40),
    ("any_hit", True, True, "mesh", True, 32, 32, 16, 40),
    ("any_hit", False, True, None, True, 16, 16, 16, 64),
    ("any_hit", True, True, None, False, 16, 8, 12, 40),
    ("any_hit", "reverse", True, "tri", True, 32, 16, 12, 64),
    ("any_hit", True, False, "mesh", False, 32, 32, 12, 24),
    ("any_hit", True, True, None, False, 8, 8, 4, 40),
    ("any_hit", False, True, "tri", False, 32, 32, 4, 64),
    ("any_hit", True, True, None, True, 32, 16, 4, 24),
    ("any_hit", "reverse", False, None, False, 16, 16, 4, 40),
]


def _case_id(case):
    query, cull, bounded, ignore, nonfinite, ts, wt, cs, n = case
    return (f"{query}-cull_{cull}-{'tmax' if bounded else 'inf'}-"
            f"ign_{ignore}-{'nan' if nonfinite else 'finite'}-"
            f"t{ts}w{wt}-c{cs}-r{n}")


@pytest.mark.parametrize("case", _MATRIX, ids=[_case_id(c) for c in _MATRIX])
def test_walk_matches_brute(scenes, case):
    query, cull, bounded, ignore, nonfinite, ts, wt, cs, n = case
    flat = scenes[cs]
    o, d = _rays(n, seed=hash(_case_id(case)) % 1000)
    if nonfinite:
        o[1, 0] = np.nan
        d[n - 2, 2] = np.inf
    o, d = jnp.asarray(o), jnp.asarray(d)
    t_max = None
    if bounded:
        t_max = jnp.asarray(np.linspace(4.0, 30.0, n, dtype=np.float32))
    ignore_tri = ignore_mesh = None
    if ignore == "tri":
        first = nearest_hit_brute(flat, o, d, cull=cull, block=128)
        ignore_tri = jnp.where(jnp.arange(n) % 2 == 0, first.tri, -1)
    elif ignore == "mesh":
        ignore_mesh = jnp.where(jnp.arange(n) % 3 == 0, 0, -1)

    hb = nearest_hit_brute(flat, o, d, ignore_tri, ignore_mesh, cull,
                           block=128, t_max=t_max)
    hw = nearest_hit_walk(flat, o, d, ignore_tri, ignore_mesh, cull,
                          tile_size=ts, walk_tile=wt, t_max=t_max,
                          any_hit=query == "any_hit", interpret=True)
    assert hw.hit.shape == (n,)
    np.testing.assert_array_equal(np.asarray(hw.hit), np.asarray(hb.hit))
    if nonfinite:
        assert not bool(hw.hit[1]) and not bool(hw.hit[n - 2])
    if query == "nearest":
        m = np.asarray(hb.hit)
        np.testing.assert_array_equal(np.asarray(hw.tri), np.asarray(hb.tri))
        np.testing.assert_allclose(np.asarray(hw.t)[m], np.asarray(hb.t)[m],
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(hw.u)[m], np.asarray(hb.u)[m],
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(hw.v)[m], np.asarray(hb.v)[m],
                                   atol=1e-5)
        assert np.all(np.asarray(hw.t)[~m] == np.float32(3.4028235e38))


def _z_quad_stack_scene(n_quads: int):
    """``n_quads`` unit quads facing +z at z = 0..n-1, one cluster each
    (cluster_size=2 == triangles per quad)."""
    from raytpu.scene.types import Material, Mesh, Scene, SceneObject

    tris = []
    for i in range(n_quads):
        z = float(i)
        # Winding chosen so snormal = normalize(cross(e2, e1)) = +z: a ray
        # travelling -z passes the backface cull (dot(n, d) <= 0).
        tris.append([[-1, -1, z], [-1, 1, z], [1, -1, z]])
        tris.append([[1, 1, z], [1, -1, z], [-1, 1, z]])
    mesh = Mesh(vertices=np.asarray(tris, np.float32),
                material=Material(reflectiveness=0.0))
    return Scene(objects=[SceneObject(meshes=[mesh])])


def test_front_to_back_settles_on_nearest():
    """Quad stack seen from +z: whatever the cluster order, the walk visits
    the nearest quad first and returns it exactly."""
    flat = _z_quad_stack_scene(6).flatten(build_octree=False, cluster_size=2)
    o = jnp.asarray(np.tile([[0.2, 0.1, 10.0]], (8, 1)), jnp.float32)
    d = jnp.asarray(np.tile([[0.0, 0.0, -1.0]], (8, 1)), jnp.float32)
    hw = nearest_hit_walk(flat, o, d, tile_size=8, interpret=True)
    hb = nearest_hit_brute(flat, o, d, block=16)
    assert np.asarray(hw.hit).all()
    np.testing.assert_allclose(np.asarray(hw.t), 5.0, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(hw.tri), np.asarray(hb.tri))


def test_tile_sizes_are_rounded_and_clamped(scenes):
    """A cull tile that is no power of two rounds up; a walk tile wider
    than the cull tile is clamped to it; fewer rays than one tile pad."""
    flat = scenes[16]
    o, d = (jnp.asarray(a) for a in _rays(20, seed=3))
    hw = nearest_hit_walk(flat, o, d, tile_size=24, walk_tile=64,
                          interpret=True)
    hb = nearest_hit_brute(flat, o, d, block=128)
    np.testing.assert_array_equal(np.asarray(hw.tri), np.asarray(hb.tri))


def test_walk_matches_tiled_on_camera_rays(scenes):
    """Coherent primary rays: the walk and TILED return the same hits (t
    to an ulp: the kernel sums each dot product in its own order)."""
    from raytpu.accel.tiled import nearest_hit_tiled
    from raytpu.core.camera import Camera, camera_rays

    flat = scenes[16]
    o, d = camera_rays(Camera(position=(0.0, 16.0, 32.0), aspect=1.0), 16, 16)
    ht = nearest_hit_tiled(flat, o, d, tile_size=64)
    hw = nearest_hit_walk(flat, o, d, tile_size=64, walk_tile=16,
                          interpret=True)
    np.testing.assert_array_equal(np.asarray(hw.tri), np.asarray(ht.tri))
    np.testing.assert_allclose(np.asarray(hw.t), np.asarray(ht.t), rtol=1e-6)


# --- platform rules (utils/backend.py) --------------------------------------


def _recorders(monkeypatch):
    """Replace both cluster backends by recorders that answer "miss"."""
    import raytpu.accel.tiled as tiled_mod
    import raytpu.kernels.walk as walk_mod

    calls = []

    def fake(name):
        def run(scene, origin, direction, *a, **k):
            calls.append((name, k.get("interpret")))
            zero = jnp.zeros(origin.shape[:1], jnp.float32)
            return Hit(hit=zero > 0, t=zero + 3.4028235e38, u=zero, v=zero,
                       tri=zero.astype(jnp.int32) - 1)
        return run

    monkeypatch.setattr(walk_mod, "nearest_hit_walk", fake("walk"))
    monkeypatch.setattr(tiled_mod, "nearest_hit_tiled", fake("tiled"))
    return calls


def _fake_backend(monkeypatch, name):
    import raytpu.utils.backend as backend_mod

    monkeypatch.setattr(backend_mod.jax, "default_backend", lambda: name)


@pytest.mark.parametrize("backend,expect", [("gpu", ("walk", False)),
                                            ("cpu", ("tiled", None))])
def test_auto_picks_by_platform(scenes, monkeypatch, backend, expect):
    calls = _recorders(monkeypatch)
    _fake_backend(monkeypatch, backend)
    o, d = (jnp.asarray(a) for a in _rays(8, seed=1))
    nearest_hit(scenes[16], o, d, intersector=Intersector.AUTO,
                brute_force_max_tris=0)
    assert calls == [expect]


@pytest.mark.parametrize("backend", ["cpu", "METAL"])
def test_pallas_off_gpu_raises_without_interpret(scenes, monkeypatch,
                                                 backend):
    calls = _recorders(monkeypatch)
    _fake_backend(monkeypatch, backend)
    o, d = (jnp.asarray(a) for a in _rays(8, seed=1))
    with pytest.raises(ValueError, match="GPU only"):
        nearest_hit(scenes[16], o, d, intersector=Intersector.PALLAS)
    assert calls == []


def test_pallas_interpret_is_explicit(scenes, monkeypatch):
    calls = _recorders(monkeypatch)
    o, d = (jnp.asarray(a) for a in _rays(8, seed=1))
    nearest_hit(scenes[16], o, d, intersector=Intersector.PALLAS,
                interpret=True)
    _fake_backend(monkeypatch, "gpu")
    nearest_hit(scenes[16], o, d, intersector=Intersector.PALLAS)
    assert calls == [("walk", True), ("walk", False)]


@pytest.mark.parametrize("backend,intersector,expect", [
    ("gpu", "auto", "walk"),
    ("cpu", "auto", "tiled"),
    ("cpu", "pallas", None),
])
def test_ring_follows_platform_rules(scenes, monkeypatch, backend,
                                     intersector, expect):
    from raytpu.dist.bigscene import nearest_hit_ring, shard_scene_clusters
    from raytpu.dist.mesh import make_mesh

    mesh = make_mesh(devices=jax.devices()[:2])
    shards = shard_scene_clusters(scenes[16], mesh)
    calls = _recorders(monkeypatch)
    _fake_backend(monkeypatch, backend)
    o, d = (jnp.asarray(a) for a in _rays(8, seed=1))
    if expect is None:
        with pytest.raises(ValueError, match="GPU only"):
            nearest_hit_ring(shards, o, d, mesh, intersector=intersector)
        return
    nearest_hit_ring(shards, o, d, mesh, intersector=intersector)
    assert {c[0] for c in calls} == {expect}
    assert all(c[1] in (None, False) for c in calls)


def test_hit_fields_of_walk_are_hit_tuple(scenes):
    o, d = (jnp.asarray(a) for a in _rays(8, seed=4))
    hw = nearest_hit_walk(scenes[16], o, d, tile_size=8, interpret=True)
    assert isinstance(hw, Hit)
    assert hw.tri.dtype == jnp.int32 and hw.t.dtype == jnp.float32
