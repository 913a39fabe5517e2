"""Multi-device rendering over a jax.sharding.Mesh.

The reference is single-node (SURVEY.md §2.5: no distributed backend —
multi-GPU only as independent device registries, interface.cpp:339). This
component is therefore new, not a port: the renderer's natural parallel
axes over several cards are

- "px" (data parallel over pixels): the image plane is tiled across
  devices; the scene/BVH is replicated; no communication is needed during
  tracing, and the film shards compose the full image (the multi-device
  analog of cpu_parallel_tiles, render/mapping_cpu.impala:3-33);
- "sp" (sample parallel): devices render *different samples* of the same
  pixels; their partial films are combined with a psum — the
  progressive-accumulation axis (driver.cpp:279-325) spread over cards.

Both axes run inside one shard_map, so XLA sees a single SPMD program and
inserts the psum (NCCL over NVLink on GPUs).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..render.integrator import render_sample


def make_mesh(n_px=None, n_sp=1, devices=None):
    """Creates a ("sp", "px") mesh. Defaults to all devices on the px
    axis (pure image-plane data parallelism). Devices are taken in
    order: every card reaches every other at the same rate, so the mesh
    follows the algorithm alone."""
    devices = devices if devices is not None else jax.devices()
    if n_px is None:
        n_px = len(devices) // n_sp
    devs = np.asarray(devices[:n_px * n_sp]).reshape(n_sp, n_px)
    return Mesh(devs, axis_names=("sp", "px"))


def shard_scene(scene, mesh):
    """Replicates scene arrays across the mesh."""
    repl = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, repl)
                        if hasattr(x, "shape") else x, scene)


def render_iteration_sharded(scene, camera, film, width, height, spp,
                             iteration, mesh, engine="tiled", sort=False):
    """One progressive iteration over the mesh.

    film: (W*H, 3) float32, sharded along "px". Each px-shard owns a
    contiguous pixel strip; each sp-rank traces spp/|sp| samples of it and
    the partials are psum'd over "sp".
    """
    n_sp = mesh.shape["sp"]
    n_px = mesh.shape["px"]
    total = width * height
    assert spp % n_sp == 0, "spp must divide the sp axis"
    # uneven W*H: pad the film to a multiple of the px axis; the padded
    # strips trace wasted rays for out-of-image pixel ids but write only
    # their own padded rows, which are sliced off below
    local = -(-total // n_px)
    total_pad = local * n_px
    if total_pad != total:
        film = jnp.concatenate(
            [film, jnp.zeros((total_pad - total, 3), film.dtype)])
    spp_local = spp // n_sp

    film_sharding = NamedSharding(mesh, P("px"))
    film = jax.device_put(film, film_sharding)
    # scene rides through jit as a replicated ARGUMENT (in_spec P()), not
    # a closure capture: captured device arrays are baked into the HLO as
    # constants, which breaks at San-Miguel scale (a ~0.5 GB constant
    # blob overflows compile-request limits and defeats donation)
    scene = shard_scene(scene, mesh)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("px")),
             out_specs=P("px"), check_vma=False)
    def step(scene_local, film_local):
        px_rank = jax.lax.axis_index("px")
        sp_rank = jax.lax.axis_index("sp")
        pixel_ids = jnp.minimum(
            px_rank * local + jnp.arange(local, dtype=jnp.int32),
            total - 1)

        def body(i, f):
            s = sp_rank * spp_local + i
            return render_sample(scene_local, camera, f, width, height,
                                 s, iteration, pixel_ids=pixel_ids,
                                 engine=engine, sort=sort)

        partial_film = jax.lax.fori_loop(
            0, spp_local, body, jnp.zeros_like(film_local))
        # 1/spp weighting: film holds per-iteration means (reference
        # accumulate semantics, mapping_cpu.impala:365-370)
        return film_local + jax.lax.psum(partial_film, "sp") * (1.0 / spp)

    out = jax.jit(step)(scene, film)
    return out[:total] if total_pad != total else out


def render_iteration_persistent_sharded(scene, camera, film, width,
                                        height, spp, iteration, mesh,
                                        pool=None, engine="tiled",
                                        sort=False, retire_every=1,
                                        compact=0):
    """Persistent-wavefront iteration over the mesh: each px shard runs
    the regeneration pool on its own pixel strip (strip-local film
    splats), each sp rank traces a disjoint sample range, partials psum
    over "sp". Bit-identical to the single-device persistent film (RNG
    seeds depend only on sample/iter/pixel)."""
    from ..render.integrator import render_iteration_persistent

    n_sp = mesh.shape["sp"]
    n_px = mesh.shape["px"]
    total = width * height
    assert spp % n_sp == 0, "spp must divide the sp axis"
    local = -(-total // n_px)
    total_pad = local * n_px
    if total_pad != total:
        film = jnp.concatenate(
            [film, jnp.zeros((total_pad - total, 3), film.dtype)])
    spp_local = spp // n_sp

    film = jax.device_put(film, NamedSharding(mesh, P("px")))
    scene = shard_scene(scene, mesh)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("px")),
             out_specs=P("px"), check_vma=False)
    def step(scene_local, film_local):
        px_rank = jax.lax.axis_index("px")
        sp_rank = jax.lax.axis_index("sp")
        delta = render_iteration_persistent(
            scene_local, camera, jnp.zeros_like(film_local), width,
            height, spp_local, iteration, pool=pool, engine=engine,
            sort=sort, retire_every=retire_every, compact=compact,
            pixel_lo=px_rank * local, n_pixels=local,
            sample_lo=sp_rank * spp_local, spp_weight=1.0 / spp)
        return film_local + jax.lax.psum(delta, "sp")

    out = jax.jit(step)(scene, film)
    return out[:total] if total_pad != total else out


def traverse_sharded(dev, rays, mesh=None, any_hit=False, engine="tiled",
                     **engine_kwargs):
    """Scene-replicated, ray-sharded traversal over a device mesh
    (SURVEY.md §2.5: the bench_traversal multi-device configuration).
    rays are split across all mesh devices along the batch axis; the BVH
    is replicated; no collectives are needed (results shard like rays).

    engine names the per-device traversal engine (traversal.engine);
    engine_kwargs pass through to it (compact)."""
    from ..traversal.engine import traverse as engine_traverse

    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    flat = Mesh(mesh.devices.reshape(-1), axis_names=("rays",))
    b = rays["org"].shape[0]
    # uneven batches: pad with dead rays (tmax < tmin skips traversal)
    b_pad = -(-b // n_dev) * n_dev
    if b_pad != b:
        def padded(k, x):
            fill = -1.0 if k == "tmax" else 0.0
            return jnp.concatenate(
                [x, jnp.full((b_pad - b,) + x.shape[1:], fill, x.dtype)])
        rays = {k: padded(k, v) for k, v in rays.items()}

    def run(dev_local, local_rays):
        return engine_traverse(dev_local, local_rays, engine,
                               any_hit=any_hit, **engine_kwargs)

    @partial(jax.shard_map, mesh=flat, in_specs=(P(), P("rays")),
             out_specs=P("rays"), check_vma=False)
    def step(dev_local, local_rays):
        return run(dev_local, local_rays)

    # dev as replicated argument, not closure capture (see
    # render_iteration_sharded): constants don't scale to 0.5 GB BVHs
    repl = NamedSharding(flat, P())
    dev = jax.tree.map(lambda x: jax.device_put(x, repl)
                       if hasattr(x, "shape") else x, dev)
    sharding = NamedSharding(flat, P("rays"))
    rays = jax.tree.map(lambda x: jax.device_put(x, sharding), rays)
    out = jax.jit(step)(dev, rays)
    if b_pad != b:
        out = {k: v[:b] for k, v in out.items()}
    return out
