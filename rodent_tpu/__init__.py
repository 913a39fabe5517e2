"""rodent_tpu — a BVH traversal library and wavefront path tracer in JAX.

A ground-up re-design of the capabilities of AnyDSL/rodent, running on
NVIDIA GPUs (and on the CPU for tests):

- Rodent's compile-time-specialized traversal variants (single/packet/hybrid
  over BVH4/BVH8, src/traversal/mapping_cpu.impala) become batched XLA
  engines over SoA ray megabatches and, on the GPU, a per-ray Pallas
  kernel through Triton (traversal/walk.py).
- Rodent's scene converter (src/driver/converter.cpp), which emits Impala
  source specializing shaders/lights/camera at compile time, becomes a Python
  scene compiler producing static config traced under jax.jit.
- Rodent's wavefront ray-stream loop (src/render/mapping_cpu.impala:352-473)
  becomes a fixed-capacity masked wavefront loop with sample regeneration.
- The SBVH builder (src/driver/bvh.h) and the OBJ/.bvh/.rays/.fbuf toolchain
  are implemented natively in C++ on the host (rodent_tpu/native).
- Multi-device scaling (new component, the reference is single node) shards
  the image plane / sample space over a jax.sharding.Mesh with psum of film.
"""

__version__ = "0.1.0"
