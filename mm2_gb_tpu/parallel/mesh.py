"""Multi-GPU / multi-host parallel mapping (SURVEY.md §5.8).

The reference is strictly single-node/single-GPU; this layer is built
new:

- the minimizer index stays on the host, and each macro-batch's reads
  are split into contiguous, anchor-balanced shards, one per card;
- chaining is embarrassingly parallel across reads, so there is NO
  inter-card communication: each card runs the chain kernel on its own
  shard (computation follows the committed operands);
- results return to the host, and output keeps the input read order;
  multi-host ranks write shards that merge deterministically by the
  global read id assigned at ingest (the same merge key the reference
  uses for output order, map.c:1284-1285).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def merge_paf_shards(shards: list[list[tuple[int, str]]]) -> list[str]:
    """Deterministic merge of per-host PAF shards by global read id."""
    allrecs = [rec for shard in shards for rec in shard]
    allrecs.sort(key=lambda t: t[0])
    return [line for _, line in allrecs]


def _shard_reads(bounds: np.ndarray, n_dev: int) -> np.ndarray:
    """Contiguous read shards balanced by anchor count; returns read-index
    boundaries of length n_dev+1."""
    n_reads = bounds.shape[0] - 1
    n = int(bounds[-1])
    if n_reads <= n_dev:
        edges = np.arange(n_dev + 1)
        return np.minimum(edges, n_reads)
    targets = np.searchsorted(bounds[1:-1],
                              (np.arange(1, n_dev) * n) // n_dev) + 1
    return np.concatenate(([0], targets, [n_reads]))


from mm2_gb_tpu.utils.opts import MM_F_SPLICE as _SPLICE_FLAG


def dispatch_batch_multichip(index, opt, seeded, mesh, metrics=None):
    """Launch chain scoring for a seeded batch with reads data-parallel
    across the mesh devices — one async dispatch_scores per card on its
    contiguous anchor-balanced shard (no collectives: chaining is
    embarrassingly parallel across reads, SURVEY.md §5.8).  Returns the
    state consumed by finish_batch_multichip."""
    from mm2_gb_tpu.models.mapper import _chain_gaps
    from mm2_gb_tpu.ops import chain_device as CT

    devs = list(mesh.devices.flat)
    if metrics is not None:
        metrics.n_batches += 1
    bounds = np.zeros(len(seeded) + 1, dtype=np.int64)
    for i, sr in enumerate(seeded):
        bounds[i + 1] = bounds[i] + sr.ax.shape[0]
    if bounds[-1] == 0:
        return seeded, bounds, []
    ax = np.concatenate([sr.ax for sr in seeded])
    ay = np.concatenate([sr.ay for sr in seeded])
    max_gap_qry, max_gap_ref = _chain_gaps(opt, 0)
    cg = np.float32(float(np.float32(opt.chain_gap_scale)) * 0.01 * index.k)
    cs = np.float32(float(np.float32(opt.chain_skip_scale)) * 0.01 * index.k)

    shard_edges = _shard_reads(bounds, len(devs))
    pends = []
    for d, dev in enumerate(devs):
        r0, r1 = int(shard_edges[d]), int(shard_edges[d + 1])
        s, e = int(bounds[r0]), int(bounds[r1])
        if e == s:
            continue
        sub_bounds = (bounds[r0:r1 + 1] - s).astype(np.int64)
        if metrics is not None:
            metrics.dev_anchors[d] = metrics.dev_anchors.get(d, 0) + e - s
        pend = CT.dispatch_scores(ax[s:e], ay[s:e], sub_bounds,
                                  max_gap_ref, max_gap_qry, opt.bw,
                                  opt.max_chain_iter, float(cg), float(cs),
                                  metrics, device=dev,
                                  is_cdna=bool(opt.flag & _SPLICE_FLAG))
        pends.append((pend, s, e))
    return seeded, bounds, pends


def finish_batch_multichip(index, opt, state, metrics=None, pool=None):
    """Collect every shard's scores and run the host finish path in
    global read order; returns [(SeededRead, regions)]."""
    import time

    from mm2_gb_tpu.models.pipeline import finish_slices

    seeded, bounds, pends = state
    n = int(bounds[-1])
    f = np.zeros(n, np.int32)
    p = np.full(n, -1, np.int64)
    t0 = time.perf_counter()
    for pend, s, e in pends:
        fs, ps = pend.collect()
        f[s:e] = fs
        p[s:e] = np.where(ps >= 0, ps + s, -1)
    t1 = time.perf_counter()
    slices = []
    for i, sr in enumerate(seeded):
        s, e = int(bounds[i]), int(bounds[i + 1])
        fp = f[s:e]
        pp = np.where(p[s:e] >= 0, p[s:e] - s, -1)
        slices.append((sr, fp, pp))
    out = finish_slices(index, opt, slices, pool)
    if metrics is not None:
        metrics.t_wait += t1 - t0
        metrics.t_finish += time.perf_counter() - t1
    return out


def map_file_multichip(index, opt, paths, mesh, metrics=None,
                       n_threads: int = 1):
    """Stream (SeededRead, regions) with reads data-parallel across the
    mesh — the multi-GPU end-to-end mapping driver.  Double-buffered
    like the single-card path: all cards score batch N while the host
    finishes batch N-1; n_threads > 1 fans the per-read finish out over
    a thread pool (kt_for analog, ordered emit)."""
    from concurrent.futures import ThreadPoolExecutor

    from mm2_gb_tpu.models.pipeline import ChainMetrics, _acc_batches

    metrics = metrics or ChainMetrics()
    pool = (ThreadPoolExecutor(max_workers=n_threads)
            if n_threads > 1 else None)
    try:
        pending = None
        for acc in _acc_batches(index, opt, paths, metrics, pool=pool):
            state = dispatch_batch_multichip(index, opt, acc, mesh, metrics)
            if pending is not None:
                yield from finish_batch_multichip(index, opt, pending,
                                                  metrics, pool)
            pending = state
        if pending is not None:
            yield from finish_batch_multichip(index, opt, pending, metrics,
                                              pool)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)


def bind_rank_to_card(rank: int) -> None:
    """Give one rank of a multi-process run one card of its host (card
    rank mod the host's card count); a JAX process otherwise reserves
    memory on every card it sees.  Must run before the backend starts.
    No-op on hosts without NVIDIA cards."""
    gpus = "/proc/driver/nvidia/gpus"
    if os.path.isdir(gpus) and os.listdir(gpus):
        jax.config.update("jax_cuda_visible_devices",
                          str(rank % len(os.listdir(gpus))))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Multi-host initialization (jax.distributed) behind a flag.

    Each host maps its own contiguous slice of the query file(s) and
    writes a PAF shard tagged by global read id; shards concatenate in
    process order (reads are assigned to processes contiguously), or via
    merge_paf_shards when interleaved.  Returns this process's index."""
    import jax as _jax
    if num_processes is None or num_processes <= 1:
        return 0
    _jax.distributed.initialize(coordinator_address=coordinator,
                                num_processes=num_processes,
                                process_id=process_id)
    return _jax.process_index()
