"""bench_shading: isolated shading-stage benchmark.

The reference version (tools/bench_shading) streams synthetic hits on a
two-triangle quad with a checkerboard texture and 4 materials, toggling
`sorted` (stream sorted by shader) and `specialized` (per-material
compiled shaders vs one generic shader) to quantify rodent's
sort-by-shader + specialization design.

Here shading is data-driven masked evaluation over material kinds
(render.bsdf), so the comparable toggles are:
  --sorted     material ids sorted (memory-coherent gathers) vs shuffled
  --mono       single-material specialization (all rays one kind; the
               upper bound that per-geometry specialized shaders reach)
Prints "N Mrays/sec" like the reference harness.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="bench_shading")
    p.add_argument("--count", type=int, default=1 << 20)
    p.add_argument("--materials", type=int, default=4)
    p.add_argument("--sorted", action="store_true")
    p.add_argument("--mono", action="store_true",
                   help="all rays share material 0 (specialization bound)")
    p.add_argument("--bench", type=int, default=8)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from ..utils.compile import enable_compile_cache
        enable_compile_cache()
    import jax.numpy as jnp
    from ..core import vmath as vm
    from ..core.tiles import tile
    from ..render import bsdf as bsdf_mod

    n = args.count
    r = np.random.RandomState(0)
    # synthetic surface batch: random normals/uv, 4 canonical materials
    # (diffuse, phong, mirror, mix) like the reference's material set
    kinds = [bsdf_mod.DIFFUSE, bsdf_mod.PHONG, bsdf_mod.MIRROR,
             bsdf_mod.MIX][:args.materials]
    mat_id = (np.zeros(n, np.int32) if args.mono
              else r.randint(0, len(kinds), n).astype(np.int32))
    if args.sorted:
        mat_id = np.sort(mat_id)
    kind = np.asarray(kinds, np.int32)[mat_id]

    normal = r.randn(n, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    out_dir = r.randn(n, 3).astype(np.float32)
    out_dir /= np.linalg.norm(out_dir, axis=1, keepdims=True)
    flip = (np.sum(out_dir * normal, axis=1) < 0)
    out_dir[flip] = -out_dir[flip]

    nv = tuple(tile(jnp.asarray(normal[:, i])) for i in range(3))
    t_, b_, n_ = vm.onb(nv)
    surf = {
        "t": t_, "b": b_, "n": n_,
        "face_normal": nv,
        "is_entering": jnp.ones_like(n_[0], bool),
    }
    shape = n_[0]
    mat = {
        "kind": tile(jnp.asarray(kind)),
        "kd": vm.splat((0.6, 0.6, 0.6), like=shape),
        "ks": vm.splat((0.3, 0.3, 0.3), like=shape),
        "ns": jnp.full_like(shape, 16.0),
        "ni": jnp.full_like(shape, 1.5),
        "tf": vm.splat((0.9, 0.9, 0.9), like=shape),
        "mix_k": jnp.full_like(shape, 0.4),
    }
    out = tuple(tile(jnp.asarray(out_dir[:, i])) for i in range(3))
    rnd0 = tile(jnp.arange(1, n + 1, dtype=jnp.uint32))

    def shade(rnd):
        in_dir, pdf, cos, color, rnd = bsdf_mod.sample(mat, surf, rnd, out)
        ev, pv = bsdf_mod.eval_pdf(mat, surf, in_dir, out)
        mixed = vm.add(vm.mul(color, ev),
                       vm.splat((1.0, 1.0, 1.0), like=pdf))
        return vm.scale(mixed, pdf + cos + pv)[0], rnd

    f = jax.jit(shade)
    o, rnd = f(rnd0)
    jax.block_until_ready(o)
    times = []
    for _ in range(args.bench):
        t0 = time.perf_counter()
        o, rnd = f(rnd)
        jax.block_until_ready(o)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    mode = ("mono" if args.mono else
            "sorted" if args.sorted else "shuffled")
    print(f"# shading {mode}, {len(kinds)} material(s), "
          f"checksum {float(jnp.sum(o)):.3e}")
    print(f"{n * 1e-6 / med:.2f} Mrays/sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
