"""ctypes bindings to the native host library (librodent_host.so).

Provides the C++ implementations of host-side components that the
reference also keeps native (SURVEY.md §2.2): the SAH BVH builder
(src/driver/bvh.h role) and the LZ4 block codec for the data/*.bin buffer
format (src/driver/buffer.h role). Builds on demand with make; callers
fall back to the pure-Python implementations when no compiler is present.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "librodent_host.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    srcs = [os.path.join(_DIR, s)
            for s in ("lz4.cpp", "bvh_builder.cpp", "obj_loader.cpp",
                      "ref_bvh.cpp")]
    if (not os.path.exists(_LIB_PATH)
            or any(os.path.getmtime(s) > os.path.getmtime(_LIB_PATH)
                   for s in srcs)):
        try:
            subprocess.run(["make", "-C", _DIR, "-s"], check=True,
                           capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.rt_lz4_compress_bound.restype = ctypes.c_int
    lib.rt_lz4_compress_bound.argtypes = [ctypes.c_int]
    lib.rt_lz4_compress.restype = ctypes.c_int
    lib.rt_lz4_compress.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int]
    lib.rt_lz4_decompress.restype = ctypes.c_int
    lib.rt_lz4_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_int]
    lib.rt_bvh_build.restype = ctypes.c_void_p
    lib.rt_bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.rt_bvh_build2.restype = ctypes.c_void_p
    lib.rt_bvh_build2.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float]
    lib.rt_bvh_num_nodes.restype = ctypes.c_int64
    lib.rt_bvh_num_nodes.argtypes = [ctypes.c_void_p]
    lib.rt_bvh_num_packets.restype = ctypes.c_int64
    lib.rt_bvh_num_packets.argtypes = [ctypes.c_void_p]
    lib.rt_bvh_copy.restype = None
    lib.rt_bvh_copy.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)] * 1 + [
        ctypes.POINTER(ctypes.c_int32)] + [
        ctypes.POINTER(ctypes.c_float)] * 4 + [
        ctypes.POINTER(ctypes.c_int32)] * 2
    lib.rt_bvh_free.restype = None
    lib.rt_bvh_free.argtypes = [ctypes.c_void_p]
    lib.rt_obj_load.restype = ctypes.c_void_p
    lib.rt_obj_load.argtypes = [ctypes.c_char_p]
    lib.rt_obj_counts.restype = None
    lib.rt_obj_counts.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.rt_obj_copy.restype = None
    lib.rt_obj_copy.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)] * 4 + [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p]
    lib.rt_obj_free.restype = None
    lib.rt_obj_free.argtypes = [ctypes.c_void_p]
    lib.rt_ref_build.restype = ctypes.c_void_p
    lib.rt_ref_build.argtypes = [ctypes.POINTER(ctypes.c_float),
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.c_int64]
    lib.rt_ref_num_nodes.restype = ctypes.c_int64
    lib.rt_ref_num_nodes.argtypes = [ctypes.c_void_p]
    lib.rt_ref_traverse.restype = ctypes.c_double
    lib.rt_ref_traverse.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.rt_ref_free.restype = None
    lib.rt_ref_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available():
    return _load() is not None


def lz4_compress(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    cap = lib.rt_lz4_compress_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.rt_lz4_compress(data, len(data), out, cap)
    if n < 0:
        raise ValueError("lz4 compression failed")
    return out.raw[:n]


def lz4_decompress(data: bytes, uncompressed_size: int) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = ctypes.create_string_buffer(uncompressed_size)
    n = lib.rt_lz4_decompress(data, len(data), out, uncompressed_size)
    if n < 0:
        raise ValueError("lz4 decompression failed (malformed input)")
    if n != uncompressed_size:
        raise ValueError(f"lz4 size mismatch: {n} != {uncompressed_size}")
    return out.raw


def bvh_build(vertices, indices4, arity=8, packet=4, leaf_threshold=4,
              quality=1, leaf_cost=0.0):
    """Native BVH build: quality=1 -> SBVH (sweep SAH + spatial splits +
    unsplitting, the reference SplitBvhBuilder tier); quality=0 -> fast
    binned SAH. leaf_cost > 0 overrides the DP collapse's C_LEAF (the
    relative cost of a leaf-packet pop vs a node pop — raise it for
    tris_hbm builds where a leaf pop pays an HBM DMA). Returns the same
    arrays as the Python builder (see accel.layout.WideBvh) or None if
    the library is absent."""
    lib = _load()
    if lib is None:
        return None
    verts = np.ascontiguousarray(vertices, np.float32)
    idx4 = np.ascontiguousarray(indices4, np.int32).reshape(-1, 4)
    num_tris = len(idx4)
    h = lib.rt_bvh_build2(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx4.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_tris, arity, packet, leaf_threshold, quality,
        float(leaf_cost))
    try:
        nn = lib.rt_bvh_num_nodes(h)
        npk = lib.rt_bvh_num_packets(h)
        bounds = np.empty((nn, 6, arity), np.float32)
        child = np.empty((nn, arity), np.int32)
        tv0 = np.empty((npk, packet, 3), np.float32)
        te1 = np.empty_like(tv0)
        te2 = np.empty_like(tv0)
        tn = np.empty_like(tv0)
        pid = np.empty((npk, packet), np.int32)
        gid = np.empty_like(pid)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rt_bvh_copy(h, bounds.ctypes.data_as(f32p),
                        child.ctypes.data_as(i32p),
                        tv0.ctypes.data_as(f32p), te1.ctypes.data_as(f32p),
                        te2.ctypes.data_as(f32p), tn.ctypes.data_as(f32p),
                        pid.ctypes.data_as(i32p), gid.ctypes.data_as(i32p))
    finally:
        lib.rt_bvh_free(h)
    return bounds, child, tv0, te1, te2, tn, pid, gid


class RefTracer:
    """Independent single-ray BVH2 engine (ref_bvh.cpp) — the
    bench_embree/bench_aila analog (tools/bench_embree/bench_embree.cpp):
    a second, fully independent implementation used to cross-check hit
    results and to anchor throughput claims with a measurement the code
    under test did not produce. Shares no code with the JAX engines or
    bvh_builder.cpp."""

    def __init__(self, vertices, indices4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        verts = np.ascontiguousarray(vertices, np.float32)
        idx4 = np.ascontiguousarray(indices4, np.int32).reshape(-1, 4)
        self._h = lib.rt_ref_build(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx4.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(idx4))
        self.num_nodes = int(lib.rt_ref_num_nodes(self._h))

    def traverse(self, org, dirs, tmin, tmax, any_hit=False):
        """Closest-hit (or first-hit) traversal of N rays. Returns
        (t (N,) f32 — tmax kept on miss, prim_id (N,) i32 — -1 on miss,
        seconds — timed inside the C engine)."""
        org = np.ascontiguousarray(org, np.float32).reshape(-1, 3)
        dirs = np.ascontiguousarray(dirs, np.float32).reshape(-1, 3)
        n = len(org)
        tmin = np.ascontiguousarray(
            np.broadcast_to(np.float32(tmin), (n,)), np.float32)
        tmax = np.ascontiguousarray(
            np.broadcast_to(np.float32(tmax), (n,)), np.float32)
        t_out = np.empty(n, np.float32)
        prim_out = np.empty(n, np.int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        secs = self._lib.rt_ref_traverse(
            self._h, org.ctypes.data_as(f32p), dirs.ctypes.data_as(f32p),
            tmin.ctypes.data_as(f32p), tmax.ctypes.data_as(f32p), n,
            1 if any_hit else 0, t_out.ctypes.data_as(f32p),
            prim_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return t_out, prim_out, float(secs)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rt_ref_free(self._h)
            self._h = None


def obj_load(path):
    """Native OBJ load (obj.cpp role): returns (vertices (V,3) f32,
    normals (V,3), texcoords (V,2), face_normals (T,3), indices (T*4,)
    i32, material names list, mtl lib list) or None if the library is
    absent or the file cannot be read."""
    lib = _load()
    if lib is None:
        return None
    h = lib.rt_obj_load(os.fsencode(path))
    if not h:
        return None
    try:
        cnt = (ctypes.c_longlong * 5)()
        lib.rt_obj_counts(h, cnt)
        nv, nt, nmat, nlibs, sbytes = [int(x) for x in cnt]
        verts = np.empty((nv, 3), np.float32)
        norms = np.empty((nv, 3), np.float32)
        texs = np.empty((nv, 2), np.float32)
        fnorm = np.empty((nt, 3), np.float32)
        idx = np.empty((nt * 4,), np.int32)
        sbuf = ctypes.create_string_buffer(max(sbytes, 1))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rt_obj_copy(h, verts.ctypes.data_as(f32p),
                        norms.ctypes.data_as(f32p),
                        texs.ctypes.data_as(f32p),
                        fnorm.ctypes.data_as(f32p),
                        idx.ctypes.data_as(i32p), sbuf)
    finally:
        lib.rt_obj_free(h)
    parts = sbuf.raw[:sbytes].split(b"\0")
    names = [p.decode("utf-8", "replace") for p in parts[:nmat]]
    libs = [p.decode("utf-8", "replace")
            for p in parts[nmat:nmat + nlibs]]
    return verts, norms, texs, fnorm, idx, names, libs
