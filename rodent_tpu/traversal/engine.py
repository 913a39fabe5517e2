"""Traversal engines and the one place that picks among them.

Every engine takes the same component-layout rays (Vec3 tuples of
(R, 128) arrays, dead rays have tmax < tmin) and returns the same hit
dict as api.traverse, so callers choose by name:

  "tiled"           XLA lockstep loop (tiled.py); compact=k adds staged
                    row compaction
  "dense"           brute force over every Tri packet (dense.py), for
                    scenes of at most DENSE_MAX_PACKETS packets
  "walk"            the per-ray stack kernel (walk.py), Pallas through
                    Triton; compiled for the GPU only
  "walk-interpret"  the same kernel in the Pallas interpreter, so that
                    tests on the CPU reach it; never selected

select_engine maps (backend, scene) to an engine; no other module
branches on the backend.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.tiles import tile
from .dense import DENSE_MAX_PACKETS, traverse_dense_components
from .tiled import traverse_components as _tiled
from .walk import traverse_walk_components

ENGINES = ("tiled", "dense", "walk", "walk-interpret")


def select_engine(bvh, platform=None):
    """The production engine for this backend and scene. On the GPU the
    per-ray walk kernel (measured faster than the XLA engines end to end
    on the H100, PERF.md "Kernels on the H100"); on the CPU the XLA
    engines, dense for scenes small enough to brute-force. Any other
    backend is an error."""
    platform = platform or jax.default_backend()
    small = bvh["tris"].shape[0] <= DENSE_MAX_PACKETS
    if platform == "gpu":
        return "walk"
    if platform == "cpu":
        return "dense" if small else "tiled"
    raise ValueError(f"no traversal engine for platform {platform!r}")


def components_fn(engine, compact=0, sub=0):
    """Engine name -> fn(dev, org, dirv, inv_d, inv_o, tmin, tmax,
    any_hit=False) over component-layout rays. compact and sub are the
    tiled engine's staged compaction and sequential sub-batches."""
    if engine == "tiled":
        return partial(_tiled, compact_stages=compact, sub_batches=sub)
    if engine == "dense":
        return traverse_dense_components
    if engine in ("walk", "walk-interpret"):
        return partial(traverse_walk_components,
                       interpret=engine == "walk-interpret")
    raise ValueError(f"unknown traversal engine {engine!r}")


def traverse(dev, rays, engine, any_hit=False, compact=0):
    """Row-layout rays (api.make_rays dict of (B,) fields) through the
    named engine; same contract as api.traverse."""
    b = rays["org"].shape[0]
    r = -(-b // 128)

    def t1(x):
        return tile(x, r)

    org = tuple(t1(rays["org"][:, i]) for i in range(3))
    dirv = tuple(t1(rays["dir"][:, i]) for i in range(3))
    inv_d = tuple(t1(rays["inv_dir"][:, i]) for i in range(3))
    inv_o = tuple(t1(rays["inv_org"][:, i]) for i in range(3))
    tmax = t1(rays["tmax"])
    if r * 128 != b:
        tmax = jnp.where(tile(jnp.ones(b, jnp.int32), r) == 0, -1.0, tmax)
    out = components_fn(engine, compact)(dev, org, dirv, inv_d, inv_o,
                                         t1(rays["tmin"]), tmax,
                                         any_hit=any_hit)
    out = {k: v.reshape(r * 128)[:b] for k, v in out.items()}
    out["t"] = jnp.where(out["prim_id"] < 0, rays["tmax"], out["t"])
    return out
