"""Multi-device cost accounting: per-shard work, padding waste,
collective volume.

The reference has no distributed layer (SURVEY.md §2.5), so there is no
counterpart to cite. The quantities that determine scaling are
computable without several cards:

- per-shard *step counts*: the persistent wavefront loop's trip count is
  the whole per-device cost (every step is one traverse+shade+retire over
  the fixed pool); imbalance across pixel strips = load imbalance. These
  are measured (not modeled) by running each shard's exact program.
- *padding waste*: uneven W*H across the px axis pads the film to
  ceil(total/n_px)*n_px rows; padded rows trace clamped duplicate pixels.
- *collective bytes*: the only collective in the render path is the psum
  of the (local, 3) f32 partial film over the sp axis (parallel.mesh);
  ray-sharded traversal needs none. Ring all-reduce moves
  2*(n_sp-1)/n_sp * bytes per device per iteration.
"""
from __future__ import annotations

import re

import numpy as np


def shard_plan(width, height, spp, n_px, n_sp=1):
    """Analytic accounting for a ("sp", "px") mesh render iteration.

    Returns a dict with per-rank sample counts, padding waste, and
    collective traffic (bytes per device per iteration)."""
    total = width * height
    local = -(-total // n_px)
    total_pad = local * n_px
    assert spp % n_sp == 0, "spp must divide the sp axis"
    spp_local = spp // n_sp
    film_local_bytes = local * 3 * 4
    return {
        "n_px": n_px,
        "n_sp": n_sp,
        "pixels_local": local,
        "samples_local": local * spp_local,
        "padded_pixels": total_pad - total,
        "padded_fraction": (total_pad - total) / total,
        # psum(partial_film, "sp"): ring all-reduce of the local film
        "collective_bytes_per_device": (
            0 if n_sp == 1
            else int(2 * (n_sp - 1) / n_sp * film_local_bytes)),
        "film_local_bytes": film_local_bytes,
    }


def hlo_cross_device_collectives(hlo_text):
    """All-reduce lines in compiled HLO that group more than one device.

    Handles both replica_groups syntaxes XLA emits: the brace form
    ``replica_groups={{0,2},{1,3}}`` (singleton groups ``{{0},{1}}`` are
    zero-traffic degenerate psums) and the iota form
    ``replica_groups=[n_groups,group_size]<=[n_devices]`` where only a
    group_size > 1 moves data. Unknown syntaxes are flagged
    conservatively so an assertion on the result fails loudly instead of
    letting a real collective pass unexamined."""
    out = []
    for ln in hlo_text.splitlines():
        if "all-reduce" not in ln or "replica_groups=" not in ln:
            continue
        tail = ln.split("replica_groups=", 1)[1]
        if tail.startswith("{"):
            # scan EVERY inner group: any multi-member group is cross-
            # device traffic; the empty form ``{}`` is XLA's
            # all-replicas-in-one-group shorthand — real traffic, flagged
            if tail.startswith("{}"):
                cross = True
            else:
                body = tail.split("}}", 1)[0] + "}}"
                groups = re.findall(r"\{([^{}]*)\}", body)
                cross = (not groups) or any("," in g for g in groups)
        elif tail.startswith("["):
            dims = [p for p in tail[1:].split("]", 1)[0].split(",")
                    if p.strip()]
            cross = len(dims) != 2 or int(dims[1]) > 1
        else:  # pragma: no cover - future HLO syntax
            cross = True
        if cross:
            out.append(ln)
    return out


def measure_shard_steps(scene, camera, width, height, spp, n_px, n_sp=1,
                        pool=None, engine="tiled", sort=False,
                        retire_every=1):
    """Measured per-shard wavefront step counts.

    Runs each (px, sp) rank's persistent iteration sequentially on the
    local device with the EXACT pixel_lo/n_pixels/sample_lo arguments the
    sharded path passes (parallel.mesh render_iteration_persistent_sharded)
    and return_steps=True. Returns an (n_sp, n_px) int array of step
    counts — max/mean is the load-imbalance factor a real mesh would pay
    (the lockstep psum barriers once per iteration, so the slowest strip
    sets the iteration time)."""
    import jax.numpy as jnp

    from ..render.integrator import render_iteration_persistent

    plan = shard_plan(width, height, spp, n_px, n_sp)
    local = plan["pixels_local"]
    spp_local = spp // n_sp
    steps = np.zeros((n_sp, n_px), np.int64)
    for sp in range(n_sp):
        for px in range(n_px):
            film = jnp.zeros((local, 3), jnp.float32)
            _, st = render_iteration_persistent(
                scene, camera, film, width, height, spp_local, 0,
                pool=pool, engine=engine, sort=sort,
                retire_every=retire_every, pixel_lo=px * local,
                n_pixels=local, sample_lo=sp * spp_local,
                spp_weight=1.0 / spp, return_steps=True)
            steps[sp, px] = int(st)
    return steps
