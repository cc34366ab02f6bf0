"""raytpu — a differentiable ray tracer built from scratch in JAX.

Re-designs the full capability surface of the reference C#/XNA Whitted-style
tracer (eitan3/xna-ray-trace, see SURVEY.md) as array programs:

- ``raytpu.core``   — pure math: XNA-parity matrices/camera, Möller–Trumbore,
                      AABB slab tests, reflect/refract.
- ``raytpu.scene``  — scene model: triangles (SoA), materials, textures,
                      lights, procedural meshes, OBJ ingestion, flattening.
- ``raytpu.accel``  — host-side octree/BVH builders producing flattened arrays
                      plus stackless on-device traversal.
- ``raytpu.render`` — the jitted wavefront renderer (primary/shadow/reflection/
                      refraction waves, adaptive supersampling).
- ``raytpu.kernels``— the Pallas (Triton) walk kernel for the GPU.
- ``raytpu.diff``   — differentiable rendering: soft-visibility gradients and
                      inverse-rendering optimization.
- ``raytpu.dist``   — multi-device/multi-host sharding (jax.sharding Mesh,
                      shard_map, collective gradient reduction).
- ``raytpu.io``     — PNG/AVI output (replaces the reference's avifil32
                      P/Invoke layer), checkpointing.
- ``raytpu.ref_oracle`` — a NumPy CPU oracle port of the reference semantics
                      used for allclose validation.
"""

__version__ = "0.1.0"

from raytpu.config import RenderConfig, TextureFiltering, UVAddressMode  # noqa: F401
