"""Scene model.

Host-side builder classes (``Material``, ``Mesh``, ``SceneObject``, ``Scene``)
mirror the reference's scene layer (Mesh.cs, Material.cs, SceneObject.cs) but
flatten into a single SoA pytree (``FlatScene``) that lives on device.

Design notes:

- The reference keeps triangles in object space and transforms each ray into
  every candidate object's space via its InverseWorld
  (OctreeSpatialManager.cs:349-364).  We instead *bake* instances: world
  transforms are applied to the triangles once at flatten time (positions by
  the world matrix, vertex normals by its inverse-transpose, face normals
  recomputed as ``normalize(cross(e2, e1))`` exactly like the content
  processor, TracerModelProcessor.cs:199-203).  One coordinate space means
  one acceleration structure, one dense triangle table, and ray batches that
  never diverge per object.  Documented deviations from the reference that
  this fixes: (a) the reference compares hit distances measured in *different
  object spaces* when scales are non-uniform (OctreeSpatialManager.cs:366-379)
  and (b) it shades with object-space normals against world-space lights
  (RayTracer.cs:520-542); both coincide with our semantics for the
  rigid/identity transforms used by all reference scenes and baseline configs.
- Per-bounce "ignore triangle" / "ignore mesh" (self-intersection avoidance,
  MeshOctree.cs:290, RayTracer.cs:554-559) are kept as integer ids carried by
  each ray.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.scene import lights as lights_mod


@dataclasses.dataclass
class Material:
    """Material parameters (Material.cs:25-57, TracerModelProcessor.cs:32-101).

    Defaults mirror the content-processor defaults: Reflectiveness 0.5,
    InterpolateNormals True, RefractionIndex 1.33.
    ``texture`` is an (H, W, 3) uint8 array (the RayTracerTexture analog).
    """

    reflectiveness: float = 0.5
    use_texture: bool = False
    transparent: bool = False
    refraction_index: float = 1.33
    interpolate_normals: bool = True
    texture: Optional[np.ndarray] = None
    diffuse_color: tuple = (1.0, 1.0, 1.0, 1.0)


@dataclasses.dataclass
class Mesh:
    """A triangle soup + material (Mesh.cs:9-41).

    ``vertices``: (T, 3, 3) float32 triangle corners (object space).
    ``uvs``: (T, 3, 2) float32 or None.
    ``normals``: (T, 3, 3) float32 vertex normals or None (face normals used).
    ``colors``: (T, 4) float32 per-triangle RGBA or None (diffuse color used).
    ``convex``: the reference's convexGeometry flag (Triangle.cs:22) — never
    set by its pipeline, supported here per mesh.
    """

    vertices: np.ndarray
    material: Material = dataclasses.field(default_factory=Material)
    uvs: Optional[np.ndarray] = None
    normals: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    convex: bool = False

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3, 3)
        t = self.vertices.shape[0]
        if self.uvs is not None:
            self.uvs = np.asarray(self.uvs, np.float32).reshape(t, 3, 2)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, np.float32).reshape(t, 3, 3)
        if self.colors is not None:
            self.colors = np.asarray(self.colors, np.float32).reshape(t, 4)

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]


@dataclasses.dataclass
class SceneObject:
    """A placed instance of a mesh list (SceneObject.cs:12-258).

    World matrix composition S·Rx·Ry·Rz·T as in SceneObject.BuildWorld
    (SceneObject.cs:183-199).
    """

    meshes: List[Mesh]
    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    name: str = ""

    def world_matrix(self) -> np.ndarray:
        # Host-side NumPy: scene baking must not touch the device (tiny jnp
        # ops each compile and dispatch a program of their own).
        from raytpu.core import xna

        return xna.compose_world_np(self.scale, self.rotation, self.position)


@dataclasses.dataclass
class Scene:
    """Host-side scene: objects + lights.  ``flatten()`` bakes to device SoA."""

    objects: List[SceneObject] = dataclasses.field(default_factory=list)
    lights: List[Any] = dataclasses.field(default_factory=list)

    def flatten(self, max_lights: int = 4, pad_tris_to: Optional[int] = None,
                build_octree: bool = True, leaf_threshold: int = 50,
                max_depth: int = 12, build_clusters: bool = True,
                cluster_size: int = 128,
                cluster_method: str = "median") -> "FlatScene":
        from raytpu.scene.flatten import flatten_scene

        return flatten_scene(
            self,
            max_lights=max_lights,
            pad_tris_to=pad_tris_to,
            build_octree=build_octree,
            leaf_threshold=leaf_threshold,
            max_depth=max_depth,
            build_clusters=build_clusters,
            cluster_size=cluster_size,
            cluster_method=cluster_method,
        )


def _static(default):
    """A FlatScene field that is pytree metadata (hashed into jit keys)."""
    return dataclasses.field(default=default, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlatScene:
    """The device-resident scene: dense SoA arrays, one world space.

    All triangle arrays are padded to a static size with ``tri_valid`` False
    on padding (padding triangles are degenerate and can never be hit, but the
    mask is still applied everywhere).  Texture images are padded to a common
    (H, W) with true sizes in ``tex_hw``.

    A frozen dataclass registered as a pytree: array fields are leaves,
    fields made with ``_static`` are metadata.
    """

    # Triangles (N, ...), world space.
    tri_v1: jnp.ndarray
    tri_e1: jnp.ndarray  # v2 - v1
    tri_e2: jnp.ndarray  # v3 - v1
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_n3: jnp.ndarray
    tri_uv1: jnp.ndarray  # (N, 2)
    tri_uv2: jnp.ndarray
    tri_uv3: jnp.ndarray
    tri_snormal: jnp.ndarray  # (N, 3) face normal = normalize(cross(e2, e1))
    tri_color: jnp.ndarray  # (N, 4) RGBA
    tri_mesh: jnp.ndarray  # (N,) int32 mesh-instance id
    tri_valid: jnp.ndarray  # (N,) bool

    # Per mesh instance (M,).
    mesh_material: jnp.ndarray  # int32
    mesh_convex: jnp.ndarray  # bool

    # Materials (K,).
    mat_reflect: jnp.ndarray
    mat_transparent: jnp.ndarray  # bool
    mat_refraction: jnp.ndarray
    mat_use_texture: jnp.ndarray  # bool
    mat_interp_normals: jnp.ndarray  # bool
    mat_texture: jnp.ndarray  # int32, -1 = none

    # Textures.
    textures: jnp.ndarray  # (T, H, W, 3) float32, raw 0..255 byte values
    tex_hw: jnp.ndarray  # (T, 2) int32 true (height, width)

    # Lights: packed dict of arrays (see lights.pack_lights).
    lights: dict

    # Acceleration structure (FlatOctree as a dict of arrays) or None.
    octree: Any

    # Cluster table (accel/clusters.py dict of arrays) or None — read by
    # TILED (accel/tiled.py) and the walk kernel (kernels/walk.py).
    clusters: Any = None

    # Packed per-triangle shading row (N, 32) f32 — one gather per shaded
    # ray instead of twelve (wavefront._gather_tri).  Layout: v1 e1 e2 n1
    # n2 n3 (3 each), uv1 uv2 uv3 (2 each), snormal (3), color (4), mesh id
    # (1, int32 bits).  None when built without pack_shade.
    tri_shade: Any = None

    # --- static metadata (not traced) ---
    num_tris: int = _static(0)
    num_meshes: int = _static(0)
    num_lights: int = _static(0)
    # Static per-light kind tags (lights.SPOT / lights.DIRECTIONAL), used
    # to pick light-static query shapes (the shadow-from-light reversal in
    # render/wavefront.py needs a position — spot lights only).
    light_kinds: tuple = _static(())
    has_transparent: bool = _static(False)
    has_textures: bool = _static(False)
    # Some material is BOTH transparent and reflective: a hit can spawn two
    # live children (reflection + refraction), so wavefront levels must
    # double.  When False (plain glass / plain mirrors), each parent has at
    # most one live child and levels stay at R0 slots
    # (render/wavefront.py::trace_colors child merge).  NOTE: this is a
    # *flatten-time* flag — if you replace(mat_reflect=...) post-flatten and
    # raise a transparent material's reflectiveness above 0, you must also
    # set has_dual_branch=True or the merged path drops the refraction
    # branch (make_fit_step does this automatically for MATERIALS fits).
    has_dual_branch: bool = _static(False)

    # Convenience ------------------------------------------------------------
    def replace(self, **changes) -> "FlatScene":
        return dataclasses.replace(self, **changes)

    def tri_material(self):
        """Per-triangle material index."""
        return self.mesh_material[self.tri_mesh]
