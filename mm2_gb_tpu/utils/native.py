"""Loader for the optional C++ host-kit (csrc/hostkit.cpp → libhostkit.so).

The host-kit provides fast native implementations of the sequential host
components (minimizer sketch, radix permutation, chain backtracking) used
outside the device compute path.  Everything here has a pure-NumPy/Python
fallback, so the package works without the native library; tests cross-check
the two.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    override = os.environ.get("MM2TPU_NATIVE_LIB")
    if override:  # e.g. csrc/libhostkit_asan.so (make -C csrc asan)
        return override
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "csrc", "libhostkit.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        # build on first use when a toolchain is available
        import shutil
        import subprocess
        if shutil.which("make") and shutil.which("g++"):
            try:
                subprocess.run(["make", "-C", os.path.dirname(path)],
                               capture_output=True, timeout=120, check=True)
            except Exception:
                return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.mmt_sketch.restype = ctypes.c_int64
    lib.mmt_sketch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
    ]
    lib.mmt_radix_perm64.restype = None
    lib.mmt_radix_perm64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mmt_chain_dp.restype = ctypes.c_int64
    lib.mmt_chain_dp.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.mmt_ksw_extz2.restype = ctypes.c_int64
    lib.mmt_ksw_extz2.argtypes = [
        u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p, u32p, ctypes.c_int64,
    ]
    lib.mmt_ksw_extd2.restype = ctypes.c_int64
    lib.mmt_ksw_extd2.argtypes = [
        u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, u32p, ctypes.c_int64,
    ]
    lib.mmt_ksw_exts2.restype = ctypes.c_int64
    lib.mmt_ksw_exts2.argtypes = [
        u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
        i32p, u32p, ctypes.c_int64,
    ]
    lib.mmt_chain_rmq.restype = ctypes.c_int64
    lib.mmt_chain_rmq.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        i32p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mmt_chain_backtrack.restype = ctypes.c_int64
    lib.mmt_chain_backtrack.argtypes = [
        i32p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mmt_sw_ll.restype = ctypes.c_int32
    lib.mmt_sw_ll.argtypes = [
        u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p, i32p,
    ]
    lib.mmt_test_zdrop.restype = ctypes.c_int32
    lib.mmt_test_zdrop.argtypes = [
        u8p, u8p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, i8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.mmt_compute_ranges.restype = None
    lib.mmt_compute_ranges.argtypes = [
        u64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i32p,
    ]
    lib.mmt_idx_lookup.restype = None
    lib.mmt_idx_lookup.argtypes = [
        u64p, i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int, u64p, ctypes.c_int64, i64p, i64p,
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mmt_seed_mz_flt.restype = None
    lib.mmt_seed_mz_flt.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, u8p,
    ]
    lib.mmt_collect_anchors.restype = ctypes.c_int64
    lib.mmt_collect_anchors.argtypes = [
        u64p, i64p, i64p, u32p, i32p, i32p, u8p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u64p, u64p,
    ]
    lib.mmt_align1.restype = ctypes.c_int64
    lib.mmt_align1.argtypes = [
        u64p, u64p, ctypes.c_int64,                      # ax, ay, n_a
        ctypes.POINTER(ctypes.c_uint8), u64p, i64p,      # seq, offsets, lens
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int8), i64p, i64p,       # mat, params, out
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def sketch(seq: bytes, w: int, k: int, rid: int, is_hpc: bool) -> np.ndarray:
    lib = _load()
    n = len(seq)
    cap = 2 * (n + 16)  # xy pairs; generous upper bound (<= 2 per base)
    out = np.empty(cap, dtype=np.uint64)
    m = lib.mmt_sketch(
        seq, n, w, k, rid, 1 if is_hpc else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), cap,
    )
    if m < 0:
        raise RuntimeError("mmt_sketch: output capacity exceeded")
    return out[: 2 * m].reshape(-1, 2).copy()


def radix_perm64(keys: np.ndarray) -> np.ndarray:
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    perm = np.empty(keys.shape[0], dtype=np.int64)
    lib.mmt_radix_perm64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        keys.shape[0],
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return perm


def chain_dp(ax: np.ndarray, ay: np.ndarray, max_dist_x: int, max_dist_y: int,
             bw: int, max_skip: int, max_iter: int,
             chn_pen_gap: float, chn_pen_skip: float,
             is_cdna: int, n_seg: int) -> tuple[np.ndarray, np.ndarray]:
    """Native chain DP: returns (f int32 scores, p int64 predecessors)."""
    lib = _load()
    n = ax.shape[0]
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    ay = np.ascontiguousarray(ay, dtype=np.uint64)
    f = np.empty(n, dtype=np.int32)
    p = np.empty(n, dtype=np.int64)
    lib.mmt_chain_dp(
        ax.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ay.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n, max_dist_x, max_dist_y, bw, max_skip, max_iter,
        chn_pen_gap, chn_pen_skip, is_cdna, n_seg,
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return f, p


def _u8(a):
    import ctypes as _c
    return a.ctypes.data_as(_c.POINTER(_c.c_uint8))


def ksw_extz2(qseq, tseq, mat, q, e, w, zdrop, end_bonus, flag):
    """Native extz2; returns (ez_scalars int32[10], cigar uint32[n])."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    mat = np.ascontiguousarray(mat, np.int8)
    ez = np.zeros(10, np.int32)
    cap = qseq.shape[0] + tseq.shape[0] + 4
    cig = np.empty(cap, np.uint32)
    n = lib.mmt_ksw_extz2(
        _u8(qseq), qseq.shape[0], _u8(tseq), tseq.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 5,
        q, e, w, zdrop, end_bonus, flag,
        ez.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap)
    if n < 0:
        raise RuntimeError("mmt_ksw_extz2: cigar capacity exceeded")
    return ez, cig[:n].copy()


def ksw_extd2(qseq, tseq, mat, q, e, q2, e2, w, zdrop, end_bonus, flag):
    """Native extd2; returns (ez_scalars int32[10], cigar uint32[n])."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    mat = np.ascontiguousarray(mat, np.int8)
    ez = np.zeros(10, np.int32)
    cap = qseq.shape[0] + tseq.shape[0] + 4
    cig = np.empty(cap, np.uint32)
    n = lib.mmt_ksw_extd2(
        _u8(qseq), qseq.shape[0], _u8(tseq), tseq.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 5,
        q, e, q2, e2, w, zdrop, end_bonus, flag,
        ez.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap)
    if n < 0:
        raise RuntimeError("mmt_ksw_extd2: cigar capacity exceeded")
    return ez, cig[:n].copy()


def test_zdrop(qseq, tseq, cigar, mat, q, e, zdrop, zdrop_inv, max_gap,
               try_inv, min_sc, min_dp_max):
    """Native mm_test_zdrop; returns 0/1/2."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    cig = np.ascontiguousarray(cigar, np.uint32)
    mat = np.ascontiguousarray(mat, np.int8)
    return int(lib.mmt_test_zdrop(
        _u8(qseq), _u8(tseq),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cig.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        q, e, zdrop, zdrop_inv, max_gap, 1 if try_inv else 0,
        min_sc, min_dp_max))


def sw_ll(qseq, tseq, mat, gapo, gape):
    """Native small SW; returns (score, qe, te)."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    mat = np.ascontiguousarray(mat, np.int8)
    qe = ctypes.c_int32()
    te = ctypes.c_int32()
    score = lib.mmt_sw_ll(
        _u8(qseq), qseq.shape[0], _u8(tseq), tseq.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 5, gapo, gape,
        ctypes.byref(qe), ctypes.byref(te))
    return int(score), int(qe.value), int(te.value)


def ksw_exts2(qseq, tseq, mat, q, e, q2, noncan, zdrop, junc_bonus, flag,
              junc):
    """Native splice extension; returns (ez_scalars int32[10], cigar)."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    mat = np.ascontiguousarray(mat, np.int8)
    junc = np.ascontiguousarray(
        junc if junc is not None else np.zeros(tseq.shape[0], np.uint8),
        np.uint8)
    ez = np.zeros(10, np.int32)
    cap = qseq.shape[0] + tseq.shape[0] + 4
    cig = np.empty(cap, np.uint32)
    n = lib.mmt_ksw_exts2(
        _u8(qseq), qseq.shape[0], _u8(tseq), tseq.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 5,
        q, e, q2, noncan, zdrop, junc_bonus, flag, _u8(junc),
        ez.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap)
    if n < 0:
        raise RuntimeError("mmt_ksw_exts2: cigar capacity exceeded")
    return ez, cig[:n].copy()


def chain_rmq_scores(ax, ay, max_dist, max_dist_inner, bw, max_chn_skip,
                     cap_rmq_size, cg, cs):
    """Native RMQ chain scores; returns (f int32, p int64)."""
    lib = _load()
    ax = np.ascontiguousarray(ax, np.uint64)
    ay = np.ascontiguousarray(ay, np.uint64)
    n = ax.shape[0]
    f = np.zeros(n, np.int32)
    p = np.full(n, -1, np.int64)
    lib.mmt_chain_rmq(
        ax.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ay.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n, max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
        cg, cs,
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return f, p


def chain_backtrack_native(f, p, z_y, min_cnt, min_sc, max_drop):
    """Native score-sorted chain extraction. Returns (u, v)."""
    lib = _load()
    f = np.ascontiguousarray(f, np.int32)
    p = np.ascontiguousarray(p, np.int64)
    z_y = np.ascontiguousarray(z_y, np.int64)
    n = f.shape[0]
    u = np.empty(max(z_y.shape[0], 1), np.uint64)
    v = np.empty(max(n, 1), np.int64)
    n_u = ctypes.c_int64()
    n_v = lib.mmt_chain_backtrack(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, min_cnt, min_sc, max_drop,
        z_y.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), z_y.shape[0],
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(n_u))
    return u[:n_u.value].copy(), v[:n_v].copy()


def idx_lookup(uniq: np.ndarray, start: np.ndarray, cnt: np.ndarray,
               boff: np.ndarray, n_buckets: int, shift: int,
               q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Bucketed minimizer point lookup (MinimizerIndex.lookup fast path)."""
    lib = _load()
    nq = q.shape[0]
    lo_out = np.empty(nq, dtype=np.int64)
    cnt_out = np.empty(nq, dtype=np.int64)
    ip = ctypes.POINTER(ctypes.c_int64)
    up = ctypes.POINTER(ctypes.c_uint64)
    lib.mmt_idx_lookup(uniq.ctypes.data_as(up),
                       start.ctypes.data_as(ip), cnt.ctypes.data_as(ip),
                       uniq.shape[0], boff.ctypes.data_as(ip), n_buckets,
                       shift, q.ctypes.data_as(up), nq,
                       lo_out.ctypes.data_as(ip), cnt_out.ctypes.data_as(ip))
    return lo_out, cnt_out


def compute_ranges(ax: np.ndarray, bounds: np.ndarray, max_dist: int,
                   max_iter: int) -> np.ndarray:
    """Native successor-range selection (chain_device.compute_ranges)."""
    lib = _load()
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    rng = np.empty(ax.shape[0], dtype=np.int32)
    lib.mmt_compute_ranges(
        ax.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), ax.shape[0],
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bounds.shape[0], max_dist, max_iter,
        rng.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return rng


def seed_mz_flt_mask(keys: np.ndarray, q_occ_max: int,
                     q_occ_frac: float) -> np.ndarray:
    """Order-preserving keep mask for the query occurrence filter."""
    lib = _load()
    n = keys.shape[0]
    keep = np.empty(n, np.uint8)
    lib.mmt_seed_mz_flt(
        np.ascontiguousarray(keys, np.uint64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint64)),
        n, q_occ_max, q_occ_frac,
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.view(bool)


def collect_anchors(occ_pos: np.ndarray, start: np.ndarray, cnt: np.ndarray,
                    q_pos: np.ndarray, q_span: np.ndarray,
                    seg_id: np.ndarray, tandem: np.ndarray,
                    qlen: int) -> tuple[np.ndarray, np.ndarray]:
    """Fused default-path anchor expansion + encode + radix permutation
    (mmt_collect_anchors; collect_seed_hits semantics, map.c:295-331)."""
    lib = _load()
    n_hits = int(cnt.sum())
    ax = np.empty(n_hits, np.uint64)
    ay = np.empty(n_hits, np.uint64)
    if n_hits == 0:
        return ax, ay
    u64 = ctypes.POINTER(ctypes.c_uint64)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.mmt_collect_anchors(
        occ_pos.ctypes.data_as(u64),
        np.ascontiguousarray(start, np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(cnt, np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(q_pos, np.uint32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint32)),
        np.ascontiguousarray(q_span, np.int32).ctypes.data_as(i32),
        np.ascontiguousarray(seg_id, np.int32).ctypes.data_as(i32),
        np.ascontiguousarray(tandem, np.uint8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)),
        q_pos.shape[0], qlen, n_hits,
        ax.ctypes.data_as(u64), ay.ctypes.data_as(u64))
    return ax, ay


def align1(ax, ay, n_a, seq_codes, offsets, lens, fwd, rc, mat, params):
    """Native per-region alignment driver (mmt_align1, alignkit.cpp —
    mm_align1 semantics, align.c:573-826).  Mutates ay (seed flags) in
    place.  Returns (out int64[12], cigar uint32[n]) or None when the
    C++ side requests the Python fallback."""
    import ctypes as _c
    lib = _load()
    u8p = _c.POINTER(_c.c_uint8)
    i64p = _c.POINTER(_c.c_int64)
    out = np.zeros(12, np.int64)
    cap = int(params[33]) // 2 + 256   # qlen//2 + slack; retried if short
    for _ in range(3):
        cig = np.empty(cap, np.uint32)
        n = lib.mmt_align1(
            ax.ctypes.data_as(_c.POINTER(_c.c_uint64)),
            ay.ctypes.data_as(_c.POINTER(_c.c_uint64)), n_a,
            seq_codes.ctypes.data_as(u8p),
            offsets.ctypes.data_as(_c.POINTER(_c.c_uint64)),
            lens.ctypes.data_as(i64p),
            fwd.ctypes.data_as(u8p), rc.ctypes.data_as(u8p),
            mat.ctypes.data_as(_c.POINTER(_c.c_int8)),
            params.ctypes.data_as(i64p),
            out.ctypes.data_as(i64p),
            cig.ctypes.data_as(_c.POINTER(_c.c_uint32)), cap)
        if n == -2:
            return None
        if n == -1:
            cap = int(out[0]) + 16
            continue
        return out, cig[:n]
    raise RuntimeError("mmt_align1: cigar capacity retry failed")
