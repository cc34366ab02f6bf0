"""Scene → FlatScene baking (host-side, NumPy).

Replaces the reference's build-time content processing
(TracerModelProcessor.cs:105-242) and runtime SceneObject/Mesh init
(SceneObject.cs:117-181, Mesh.cs:27-32): instance transforms are applied to
vertices (world matrix) and vertex normals (inverse-transpose, normalized —
TracerModelProcessor.cs:190-197), face normals recomputed as
``normalize(cross(e2, e1))`` (TracerModelProcessor.cs:199-203).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from raytpu.scene import lights as lights_mod
from raytpu.scene.types import FlatScene, Scene


def _transform_points(p: np.ndarray, m: np.ndarray) -> np.ndarray:
    return p @ m[:3, :3] + m[3, :3]


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def flatten_scene(scene: Scene, max_lights: int = 4,
                  pad_tris_to: Optional[int] = None,
                  build_octree: bool = True, leaf_threshold: int = 50,
                  max_depth: int = 12, build_clusters: bool = True,
                  cluster_size: int = 128,
                  cluster_method: str = "median") -> FlatScene:
    tri_v = []
    tri_n = []
    tri_uv = []
    tri_color = []
    tri_mesh = []
    mesh_material = []
    mesh_convex = []
    materials = []  # unique Material objects
    mat_ids = {}

    mesh_id = 0
    for obj in scene.objects:
        world = obj.world_matrix()
        # Inverse-transpose for normals (TracerModelProcessor.cs:140-141).
        inv_t = np.linalg.inv(world).T.astype(np.float32)
        for mesh in obj.meshes:
            t = mesh.num_triangles
            v = _transform_points(mesh.vertices.reshape(-1, 3), world)
            v = v.reshape(t, 3, 3).astype(np.float32)
            if mesh.normals is not None:
                n = mesh.normals.reshape(-1, 3) @ inv_t[:3, :3]
                norms = np.linalg.norm(n, axis=-1, keepdims=True)
                n = (n / np.where(norms == 0, 1, norms)).reshape(t, 3, 3)
            else:
                # No normal channel: fall back to face normals per corner.
                e1 = v[:, 1] - v[:, 0]
                e2 = v[:, 2] - v[:, 0]
                fn = np.cross(e2, e1)
                fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
                n = np.repeat(fn[:, None, :], 3, axis=1)
            uv = mesh.uvs if mesh.uvs is not None else np.zeros((t, 3, 2), np.float32)
            if mesh.colors is not None:
                col = mesh.colors
            else:
                col = np.tile(
                    np.asarray(mesh.material.diffuse_color, np.float32), (t, 1)
                )
            key = id(mesh.material)
            if key not in mat_ids:
                mat_ids[key] = len(materials)
                materials.append(mesh.material)
            tri_v.append(v)
            tri_n.append(n.astype(np.float32))
            tri_uv.append(uv.astype(np.float32))
            tri_color.append(col.astype(np.float32))
            tri_mesh.append(np.full(t, mesh_id, np.int32))
            mesh_material.append(mat_ids[key])
            mesh_convex.append(mesh.convex)
            mesh_id += 1

    if not tri_v:
        raise ValueError("scene has no meshes")

    v = np.concatenate(tri_v)
    n = np.concatenate(tri_n)
    uv = np.concatenate(tri_uv)
    color = np.concatenate(tri_color)
    mesh_idx = np.concatenate(tri_mesh)
    num_tris = v.shape[0]

    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    snormal = np.cross(e2, e1)
    snormal /= np.maximum(np.linalg.norm(snormal, axis=-1, keepdims=True), 1e-30)

    # Build the octree over the *unpadded* triangles.
    octree = None
    if build_octree:
        from raytpu.accel.octree import build_octree

        octree = build_octree(v, leaf_threshold=leaf_threshold, max_depth=max_depth)

    clusters = None
    if build_clusters:
        from raytpu.accel.clusters import build_clusters as _build_clusters

        clusters = _build_clusters(v, cluster_size=cluster_size,
                                   method=cluster_method)

    pad_to = pad_tris_to or num_tris
    if pad_to < num_tris:
        raise ValueError("pad_tris_to smaller than triangle count")
    valid = np.zeros(pad_to, bool)
    valid[:num_tris] = True

    # Textures: pad to common shape.
    tex_list = [m.texture for m in materials if m.texture is not None]
    if tex_list:
        max_h = max(t.shape[0] for t in tex_list)
        max_w = max(t.shape[1] for t in tex_list)
        textures = np.zeros((len(tex_list), max_h, max_w, 3), np.float32)
        tex_hw = np.zeros((len(tex_list), 2), np.int32)
        ti = 0
        tex_of_mat = {}
        for mi, m in enumerate(materials):
            if m.texture is not None:
                t = np.asarray(m.texture)
                if t.ndim == 2:
                    t = np.repeat(t[..., None], 3, axis=-1)
                textures[ti, : t.shape[0], : t.shape[1]] = t[..., :3].astype(np.float32)
                tex_hw[ti] = (t.shape[0], t.shape[1])
                tex_of_mat[mi] = ti
                ti += 1
        mat_texture = np.array(
            [tex_of_mat.get(i, -1) for i in range(len(materials))], np.int32
        )
    else:
        textures = np.zeros((1, 1, 1, 3), np.float32)
        tex_hw = np.ones((1, 2), np.int32)
        mat_texture = np.full(len(materials), -1, np.int32)

    lights = lights_mod.pack_lights(scene.lights, max_lights=max_lights)

    # Packed shading row (see FlatScene.tri_shade): one (32,)-float gather
    # per shaded ray replaces twelve separate gathers in the hot path.
    npad = pad_to
    shade = np.zeros((npad, 32), np.float32)
    nrows = num_tris
    shade[:nrows, 0:3] = v[:, 0]
    shade[:nrows, 3:6] = e1
    shade[:nrows, 6:9] = e2
    shade[:nrows, 9:12] = n[:, 0]
    shade[:nrows, 12:15] = n[:, 1]
    shade[:nrows, 15:18] = n[:, 2]
    shade[:nrows, 18:20] = uv[:, 0]
    shade[:nrows, 20:22] = uv[:, 1]
    shade[:nrows, 22:24] = uv[:, 2]
    shade[:nrows, 24:27] = snormal
    shade[:nrows, 27:31] = color
    shade[:, 31] = np.concatenate(
        [mesh_idx, np.full(npad - nrows, -1, np.int32)]
    ).view(np.float32)

    def dev(x):
        return jnp.asarray(x)

    return FlatScene(
        tri_v1=dev(_pad_rows(v[:, 0], pad_to)),
        tri_e1=dev(_pad_rows(e1, pad_to)),
        tri_e2=dev(_pad_rows(e2, pad_to)),
        tri_n1=dev(_pad_rows(n[:, 0], pad_to)),
        tri_n2=dev(_pad_rows(n[:, 1], pad_to)),
        tri_n3=dev(_pad_rows(n[:, 2], pad_to)),
        tri_uv1=dev(_pad_rows(uv[:, 0], pad_to)),
        tri_uv2=dev(_pad_rows(uv[:, 1], pad_to)),
        tri_uv3=dev(_pad_rows(uv[:, 2], pad_to)),
        tri_snormal=dev(_pad_rows(snormal, pad_to)),
        tri_color=dev(_pad_rows(color, pad_to)),
        tri_mesh=dev(_pad_rows(mesh_idx, pad_to)),
        tri_valid=dev(valid),
        mesh_material=dev(np.asarray(mesh_material, np.int32)),
        mesh_convex=dev(np.asarray(mesh_convex, bool)),
        mat_reflect=dev(np.asarray([m.reflectiveness for m in materials], np.float32)),
        mat_transparent=dev(np.asarray([m.transparent for m in materials], bool)),
        mat_refraction=dev(
            np.asarray([m.refraction_index for m in materials], np.float32)
        ),
        mat_use_texture=dev(np.asarray([m.use_texture for m in materials], bool)),
        mat_interp_normals=dev(
            np.asarray([m.interpolate_normals for m in materials], bool)
        ),
        mat_texture=dev(mat_texture),
        textures=dev(textures),
        tex_hw=dev(tex_hw),
        lights={k: dev(a) for k, a in lights.items()},
        octree=(
            octree.as_device_arrays(v[:, 0], e1, e2, snormal, mesh_idx)
            if octree is not None
            else None
        ),
        clusters=(
            clusters.as_device_arrays(v[:, 0], e1, e2, snormal, mesh_idx)
            if clusters is not None
            else None
        ),
        tri_shade=dev(shade),
        num_tris=num_tris,
        num_meshes=mesh_id,
        num_lights=len(scene.lights),
        light_kinds=tuple(
            lights_mod.SPOT if isinstance(lt, lights_mod.SpotLight)
            else lights_mod.DIRECTIONAL
            for lt in scene.lights
        ),
        has_transparent=bool(any(m.transparent for m in materials)),
        has_textures=bool(tex_list),
        has_dual_branch=bool(any(
            m.transparent and m.reflectiveness > 0.0 for m in materials)),
    )
