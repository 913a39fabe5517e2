"""bench_interface: cost of opaque vs specialized shading interfaces.

The reference version (tools/bench_interface) compares texture descriptors
whose border/filter modes are runtime enums (`opaque`) against ones that
are compile-time constants folded by partial evaluation (`specialized`).
The JAX analog of Impala's partial evaluation is jit specialization on
static Python config: the specialized variant bakes border/filter into the
traced program, the opaque variant carries them as traced ints and
evaluates all modes with masks.

Usage:
  python -m rodent_tpu.tools.bench_interface [--count N] [--opaque] [--cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="bench_interface")
    p.add_argument("--count", type=int, default=1 << 20)
    p.add_argument("--opaque", action="store_true",
                   help="runtime border/filter enums instead of baked")
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
    from ..render import texture as tx

    r = np.random.RandomState(0)
    img = r.rand(256, 256, 3).astype(np.float32)
    n = args.count
    uv = jnp.asarray(r.rand(n, 2).astype(np.float32) * 2.0 - 0.5)

    if args.opaque:
        # runtime enums: evaluate every (border, filter) combination and
        # select — what a non-specialized interface costs
        border_mode = jnp.zeros(n, jnp.int32)  # could vary per ray
        filter_mode = jnp.ones(n, jnp.int32)

        def sample(uv):
            outs = []
            for b in (tx.BORDER_CLAMP, tx.BORDER_REPEAT):
                for f in (tx.FILTER_NEAREST, tx.FILTER_BILINEAR):
                    outs.append(tx.sample_texture(img, uv, border=b,
                                                  filter=f))
            sel = border_mode * 2 + filter_mode
            out = outs[0]
            for i in range(1, 4):
                out = jnp.where((sel == i)[:, None], outs[i], out)
            return out
    else:
        def sample(uv):
            return tx.sample_texture(img, uv, border=tx.BORDER_REPEAT,
                                     filter=tx.FILTER_BILINEAR)

    f = jax.jit(sample)
    o = f(uv)
    jax.block_until_ready(o)
    times = []
    for _ in range(args.bench):
        t0 = time.perf_counter()
        o = f(uv)
        jax.block_until_ready(o)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    mode = "opaque" if args.opaque else "specialized"
    print(f"# texture interface {mode}, checksum {float(jnp.sum(o)):.3e}")
    print(f"{n * 1e-6 / med:.2f} Mlookups/sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
