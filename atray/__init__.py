"""ATRay: a differentiable path tracer in JAX, run on an NVIDIA H100.

A framework with the capabilities of the reference CPU path tracer
AdhavanT/ATRay (see SURVEY.md): OBJ triangle meshes, spheres, planes, an
acceleration structure, multi-bounce stochastic shading, tile/ray-parallel
execution, live progress, profiling, and image output — re-designed for an
accelerator:

- geometry is SoA ``jnp`` arrays, never scalar vector classes
  (reference: Source/PL/PL_math.h:47-185 scalar Vec3 — not replicated);
- traversal is a stackless skip-link BVH so per-ray state is one int32
  (reference: Source/engine/renderer/kd_tree.cpp:337-465 explicit stacks),
  walked by one GPU lane per ray (kernels/bvh_hit.py);
- parallelism is SPMD sharding over a device mesh, not an atomic work queue
  (reference: Source/engine/tools/work_queue.h);
- the whole pipeline is differentiable (pixel loss -> gradients to vertices,
  normals, materials) — a capability the reference does not have.
"""

__version__ = "0.1.0"

from atray.config import KDTreeConfig, MeshConfig, RenderSettings
from atray.core.camera import Camera, make_camera
from atray.scene.data import Materials, Scene, TriMesh, Spheres, Planes
