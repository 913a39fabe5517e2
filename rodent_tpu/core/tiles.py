"""(R, 128) tile-layout helpers shared by traversal and shading.

B batch elements live as (R, 128) arrays (R = ceil(B/128)): the
component layout of core.vmath with a fixed row width, so every engine
and shading stage shares one ray-slot indexing.
"""
from __future__ import annotations

import jax.numpy as jnp


def num_tiles(b):
    return -(-b // 128)


def tile(x, r=None):
    """(B, ...) -> (R, 128): pads with zeros."""
    b = x.shape[0]
    r = r or num_tiles(b)
    pad = r * 128 - b
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
    return x.reshape((r, 128) + x.shape[1:])


def untile(x, b):
    """(R, 128, ...) -> (B, ...)."""
    return x.reshape((x.shape[0] * 128,) + x.shape[2:])[:b]


def pad_mask(b, r=None):
    """True for real elements, False for padding."""
    r = r or num_tiles(b)
    return tile(jnp.ones(b, jnp.int32), r) == 1


def gather_cols(table, idx):
    """Flat row gather + relayout to component-major.

    table: (N, C); idx: (R, 128) int32. Returns (C, R, 128) so each
    component is a full-tile slice (single efficient gather + one
    transpose)."""
    r = idx.shape[0]
    rows = table[idx.reshape(r * 128)]
    return rows.T.reshape(table.shape[1], r, 128)


# A ~32-deep where-chain is ~N+N*C cheap full-tile vector ops (no memory
# indirection at all) — the same trick gather_material / render.light
# use for small tables, generalized to any packed row table.
SELECT_CHAIN_ROWS = 32


def gather_cols_select(table, idx):
    """gather_cols for tiny tables (<= SELECT_CHAIN_ROWS rows) as a pure
    select chain: bit-identical values, zero gathers. Runs the chain on
    the int32 bitcast of the table — packed rows carry bitcast integer
    columns whose bit patterns are denormal as f32, and integer selects
    can never flush them (f32 arithmetic with flush-to-zero would)."""
    import jax
    n, c = table.shape
    ti = jax.lax.bitcast_convert_type(table, jnp.int32)
    cols = [jnp.broadcast_to(ti[0, j], idx.shape) for j in range(c)]
    for i in range(1, n):
        m = idx == i
        cols = [jnp.where(m, ti[i, j], col) for j, col in enumerate(cols)]
    out = jnp.stack(cols)                      # (C, R, 128) int32
    return jax.lax.bitcast_convert_type(out, table.dtype)
