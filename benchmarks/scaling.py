"""Multi-device scaling benchmark.

Measures chaining throughput (anchor pairs/s) and end-to-end mapped
reads/s at increasing device counts, and gates every count on the
single-device output.  Pass --virtual N to use an N-device CPU mesh
(interpret-mode kernels: control flow only, no speed); on a GPU host it
uses the real cards.  Prints one JSON line.

Usage:
    python benchmarks/scaling.py [--devices N] [--reads N] [--virtual N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_scaling(n_devices: int, n_reads: int) -> dict:
    import jax
    import numpy as np

    from mm2_gb_tpu.models.index import MinimizerIndex
    from mm2_gb_tpu.models.pipeline import seed_read
    from mm2_gb_tpu.ops import chain_device
    from mm2_gb_tpu.parallel.mesh import make_mesh
    from mm2_gb_tpu.utils import opts as O
    from mm2_gb_tpu.utils.fastx import SeqRecord
    from mm2_gb_tpu.utils.simulate import random_reference, simulate_readset

    ref = random_reference(2_000_000, seed=1)
    reads = simulate_readset(ref, n_reads, 10_000, 50_000, seed=2)
    io, mo = O.set_preset(None)
    index = MinimizerIndex.from_strings([ref], io, names=["chr1"])
    O.mapopt_update(mo, index)
    seeded = [seed_read(index, mo, SeqRecord(i, n, s))
              for i, (n, s) in enumerate(reads)]
    bounds = np.zeros(len(seeded) + 1, np.int64)
    for i, sr in enumerate(seeded):
        bounds[i + 1] = bounds[i] + sr.ax.shape[0]
    ax = np.concatenate([sr.ax for sr in seeded])
    md = max(mo.max_gap, mo.bw)
    rng = chain_device.compute_ranges(ax, bounds, md, mo.max_chain_iter)
    pairs = int(rng.astype(np.int64).sum())

    from mm2_gb_tpu.parallel.mesh import (dispatch_batch_multichip,
                                          finish_batch_multichip)

    def chain_scores(mesh):
        _, _, pends = dispatch_batch_multichip(index, mo, seeded, mesh)
        f = np.zeros(ax.shape[0], np.int32)
        p = np.full(ax.shape[0], -1, np.int64)
        for pend, s, e in pends:
            fs, ps = pend.collect()
            f[s:e] = fs
            p[s:e] = np.where(ps >= 0, ps + s, -1)
        return f, p
    from mm2_gb_tpu.utils.paf import write_paf

    def paf_digest(finished) -> str:
        import hashlib
        h = hashlib.sha256()
        for sr, regs in finished:
            for r in regs:
                h.update(write_paf(r, sr.rec.name, sr.rec.length, index,
                                   mo.flag, sr.rep_len).encode())
        return h.hexdigest()

    results: dict = {"config": {"n_reads": n_reads, "n_anchors": int(
        ax.shape[0]), "pairs": pairs, "backend": None}, "points": {}}
    f1 = p1 = None
    paf1 = None
    d = 1
    while d <= n_devices:
        mesh = make_mesh(d)
        f, p = chain_scores(mesh)  # compile
        if d == 1:
            f1, p1 = f, p
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            chain_scores(mesh)
        dt = (time.perf_counter() - t0) / reps
        # e2e mapped reads/s: full dispatch->finish (backtrack + post)
        fin = finish_batch_multichip(index, mo, dispatch_batch_multichip(
            index, mo, seeded, mesh), None)  # compile
        if d == 1:
            paf1 = paf_digest(fin)
        t0 = time.perf_counter()
        for _ in range(reps):
            fin = finish_batch_multichip(index, mo, dispatch_batch_multichip(
                index, mo, seeded, mesh), None)
        dt_e2e = (time.perf_counter() - t0) / reps
        # determinism gate: every device count must produce the same
        # chain scores/predecessors AND the same PAF as the single-
        # device run (the multi-chip analog of the byte contract)
        det = bool(np.array_equal(f1, f) and np.array_equal(p1, p)
                   and paf_digest(fin) == paf1)
        # load balance: on real cards the wall is the max shard, so
        # speedup is bounded by total/(d*max_shard_pairs) — report it
        # alongside the (host-bound on a 1-core virtual mesh) rates
        from mm2_gb_tpu.parallel.mesh import _shard_reads
        sb = _shard_reads(bounds, d)
        shard_pairs = np.add.reduceat(
            rng.astype(np.int64), bounds[sb[:-1]].astype(np.int64)
        ) if d > 1 else np.array([pairs])
        balance = pairs / (d * max(int(shard_pairs.max()), 1))
        results["points"][d] = {"pairs_per_s": pairs / dt,
                                "chain_reads_per_s": len(seeded) / dt,
                                "e2e_reads_per_s": len(seeded) / dt_e2e,
                                "load_balance": round(balance, 4),
                                "deterministic_vs_d1": det}
        print(f"devices={d}: {pairs / dt / 1e9:.2f} Gpairs/s chain, "
              f"{len(seeded) / dt_e2e:.0f} mapped reads/s e2e, "
              f"deterministic={det}", file=sys.stderr)
        assert det, f"nondeterministic output at {d} devices"
        d *= 2
    results["config"]["backend"] = jax.default_backend()
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--reads", type=int, default=64)
    ap.add_argument("--virtual", type=int, default=None)
    args = ap.parse_args()

    if args.virtual:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            f" --xla_force_host_platform_device_count="
                            f"{args.virtual}").strip()
        return subprocess.run(
            [sys.executable, __file__, "--devices", str(args.virtual),
             "--reads", str(args.reads)], env=env).returncode

    import jax
    n = args.devices or len(jax.devices())
    if n > len(jax.devices()):
        raise SystemExit(f"asked for {n} devices, backend "
                         f"{jax.default_backend()} has "
                         f"{len(jax.devices())}")
    out = run_scaling(n, args.reads)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
