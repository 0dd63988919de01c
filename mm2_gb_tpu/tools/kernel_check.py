"""Chain kernel checks against the host oracle, at any batch width.

The same functions serve the GPU-marked tests (small batches) and
chip_smoke.py's kernel phase (a full macro-batch at the auto caps):
build a seeded batch of reads from a simulated reference, score it on
the device path (ops/chain_device.dispatch_scores), and require f and p
to equal the host oracle (ops/chain._chain_dp_scores) exactly — the
byte contract allows no tolerance.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from mm2_gb_tpu.models.mapper import _chain_gaps
from mm2_gb_tpu.ops import chain as chain_ops
from mm2_gb_tpu.ops import chain_device as CD


@dataclass
class Batch:
    ax: np.ndarray
    ay: np.ndarray
    bounds: np.ndarray       # read offsets, with the total
    max_dist_x: int
    max_dist_y: int
    bw: int
    max_iter: int
    cg: float
    n_reads: int


def sample_batch(ref_len: int, n_arrays: int, n_reads: int, min_len: int,
                 max_len: int, seed: int, max_anchors: int,
                 preset: str = "map-ont") -> Batch:
    """Seed simulated reads against a repeat-planted random reference
    until the next read would pass `max_anchors` (the batch cap)."""
    from mm2_gb_tpu.models.index import MinimizerIndex
    from mm2_gb_tpu.models.pipeline import seed_read
    from mm2_gb_tpu.utils import opts as O
    from mm2_gb_tpu.utils.fastx import SeqRecord
    from mm2_gb_tpu.utils.simulate import (random_repetitive_reference,
                                           simulate_readset)
    ref = random_repetitive_reference(ref_len, seed=seed, n_arrays=n_arrays)
    reads = simulate_readset(ref, n_reads, min_len, max_len, seed=seed + 1)
    io, mo = O.set_preset(preset)
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_strings([ref], io, names=["chr1"])
    O.mapopt_update(mo, index)
    axs, ays, bounds = [], [], [0]
    for i, (name, seq) in enumerate(reads):
        sr = seed_read(index, mo, SeqRecord(i, name, seq))
        if bounds[-1] + sr.ax.shape[0] > max_anchors:
            break
        axs.append(sr.ax)
        ays.append(sr.ay)
        bounds.append(bounds[-1] + sr.ax.shape[0])
    max_gap_qry, max_gap_ref = _chain_gaps(mo, 0)
    cg = float(np.float32(float(np.float32(mo.chain_gap_scale))
                          * 0.01 * index.k))
    return Batch(np.concatenate(axs), np.concatenate(ays),
                 np.array(bounds, np.int64), max_gap_ref, max_gap_qry,
                 mo.bw, mo.max_chain_iter, cg, len(bounds) - 1)


def oracle(b: Batch, is_cdna: bool = False, cs: float = 0.0
           ) -> tuple[np.ndarray, np.ndarray]:
    """Host scores read by read (the oracle wants each read's anchors
    on their own)."""
    f = np.zeros(b.ax.shape[0], np.int32)
    p = np.full(b.ax.shape[0], -1, np.int64)
    for r in range(b.n_reads):
        s, e = int(b.bounds[r]), int(b.bounds[r + 1])
        if s == e:
            continue
        fo, po = chain_ops._chain_dp_scores(
            b.ax[s:e], b.ay[s:e], max(b.max_dist_x, b.bw),
            max(b.max_dist_y, b.bw), b.bw, 2**31 - 1, b.max_iter,
            np.float32(b.cg), np.float32(cs), is_cdna, 1)
        f[s:e] = fo
        p[s:e] = np.where(po >= 0, po + s, -1)
    return f, p


def check(b: Batch, is_cdna: bool = False, cs: float = 0.0) -> dict:
    """Device path vs oracle: exact equality of f and p, plus counts."""
    from mm2_gb_tpu.models.pipeline import ChainMetrics
    met = ChainMetrics()
    t0 = time.perf_counter()
    fd, pd = CD.dispatch_scores(b.ax, b.ay, b.bounds, b.max_dist_x,
                                b.max_dist_y, b.bw, b.max_iter, b.cg, cs,
                                metrics=met, is_cdna=is_cdna).collect()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    fo, po = oracle(b, is_cdna, cs)
    t_host = time.perf_counter() - t0
    bad = int(np.count_nonzero((fd != fo) | (pd != po)))
    rng = CD.compute_ranges(b.ax, b.bounds, max(b.max_dist_x, b.bw),
                            b.max_iter)
    seg = np.diff(CD.cut_segments(rng))
    return {"exact": bad == 0, "mismatches": bad, "reads": b.n_reads,
            "anchors": int(b.ax.shape[0]), "segments": int(seg.shape[0]),
            "host_segments": met.n_host_segs,
            "longest_segment": int(seg.max()),
            "pairs": int(rng.sum(dtype=np.int64)),
            "device_path_s": t_dev, "oracle_s": t_host}


def kernel_time(b: Batch, reps: int = 5) -> dict:
    """Median kernel time on device-resident operands (the transfer and
    host planning excluded), after one compiling call."""
    import jax
    md = max(b.max_dist_x, b.bw)
    rng = CD.compute_ranges(b.ax, b.bounds, md, b.max_iter)
    lo, hi = CD.plan_programs(CD.cut_segments(rng))
    n = b.ax.shape[0]
    ops = np.zeros((3, CD._quant_size(n + CD.BLOCK)), np.int32)
    ops[0, :n] = (b.ax & np.uint64(0xFFFFFFFF)).astype(np.int32)
    ops[1, :n] = (b.ay & np.uint64(0xFFFFFFFF)).astype(np.int32)
    ops[2, :n] = rng
    prog = np.zeros((2, CD._quant_size(lo.shape[0], floor=64)), np.int32)
    prog[0, :lo.shape[0]] = lo
    prog[1, :hi.shape[0]] = hi
    ops, prog = jax.device_put((ops, prog))
    span = int((int(b.ay[0]) >> 32) & 0xFF)

    def run():
        return jax.block_until_ready(CD.chain_kernel(
            prog, ops, span=span, max_dist_x=md,
            max_dist_y=max(b.max_dist_y, b.bw), bw=b.bw, cg=b.cg, cs=0.0,
            interpret=CD.use_interpret()))

    t0 = time.perf_counter()
    run()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    return {"first_call_s": first, "kernel_s": med, "times_s": times,
            "pairs_per_s": int(rng.sum(dtype=np.int64)) / med}


def mg_log2_sweep() -> bool:
    """Device _mg_log2_f32 equals the host mg_log2 bit for bit over
    every dd + 1 up to 4097 and a random sample up to 2^24."""
    import jax
    import jax.numpy as jnp

    from mm2_gb_tpu.utils.hashkit import mg_log2
    dd = np.concatenate([np.arange(1, 4097), np.random.default_rng(0)
                         .integers(1, 2**24, 200_000), [2**24 - 1]])
    x = (dd + 1).astype(np.float32)
    dev = np.asarray(jax.device_get(
        jax.jit(CD._mg_log2_f32)(jnp.asarray(x))))
    return bool(np.array_equal(dev.view(np.uint32),
                               mg_log2(x).view(np.uint32)))


def wide_gap_batch(n: int = 400, seed: int = 0) -> Batch:
    """Anchors whose pair gaps dd spread up to 2^24: the float penalty
    terms (cg*dd, cs*dg, mg_log2(dd+1)) then round differently if the
    device contracts a multiply and an add into one FMA."""
    rng = np.random.default_rng(seed)
    rpos = np.cumsum(rng.integers(1, 2**19, n))
    qpos = np.cumsum(rng.integers(1, 2**15, n))
    ax = rpos.astype(np.uint64)
    ay = (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64)
    return Batch(ax, ay, np.array([0, n], np.int64), 2**25, 2**25, 2**25,
                 64, 0.12, 1)
