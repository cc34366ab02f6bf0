"""Pallas kernels for the GPU.

The reference's performance-critical inner loops are C# hot loops
(Möller–Trumbore in RayExtensions.cs:13-75, the leaf triangle scan in
MeshOctree.cs:288-304); here they are one Pallas kernel, compiled through
Triton, that walks each ray tile's candidate clusters front to back and
intersects them in registers (kernels/walk.py).
"""

from raytpu.kernels.walk import nearest_hit_walk  # noqa: F401
