"""Device chaining kernels vs the host oracle (interpret mode on CPU).

Mirrors the reference's own GPU-vs-CPU validation strategy
(gpu/debug.h:31-39 check_score/check_range): identical f[] scores and
predecessors are required, which in turn guarantees byte-identical PAF.
"""

import numpy as np
import pytest

from mm2_gb_tpu.ops import chain as chain_ops
from mm2_gb_tpu.ops import chain_device

CG = float(np.float32(float(np.float32(0.8)) * 0.01 * 15))


def _synthetic_anchors(n, seed, step_hi=12, jitter=6, rev_frac=0.0):
    rng = np.random.default_rng(seed)
    rpos = np.cumsum(rng.integers(1, step_hi, n))
    qpos = rpos + rng.integers(-jitter, jitter + 1, n)
    qpos = np.maximum.accumulate(np.maximum(qpos, 1))
    ax = rpos.astype(np.uint64)
    ay = (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64)
    return ax, ay


def _device_vs_oracle(ax, ay, max_dist=5000, bw=500, max_iter=5000):
    bounds = np.array([0, ax.shape[0]], dtype=np.int64)
    fd, pd = chain_device.chain_scores_device(ax, ay, bounds, max_dist,
                                           max_dist, bw, max_iter, CG, 0.0)
    fo, po = chain_ops._chain_dp_scores(ax, ay, max_dist, max_dist, bw,
                                        2**31 - 1, max_iter, np.float32(CG),
                                        np.float32(0.0), False, 1)
    assert np.array_equal(fo, fd)
    assert np.array_equal(po, pd)


def test_small_segments():
    ax, ay = _synthetic_anchors(50, 0)
    _device_vs_oracle(ax, ay)


def test_medium_dense():
    ax, ay = _synthetic_anchors(500, 1, step_hi=6)
    _device_vs_oracle(ax, ay)


def test_multi_segment_gaps():
    """Anchors with >max_dist gaps produce several independent segments."""
    chunks = []
    base = 0
    for s in range(5):
        ax, ay = _synthetic_anchors(80, s + 2)
        chunks.append((ax + np.uint64(base), ay))
        base += int(ax[-1]) + 50000
    ax = np.concatenate([c[0] for c in chunks])
    ay = np.concatenate([c[1] for c in chunks])
    rng = chain_device.compute_ranges(ax, np.array([0, ax.shape[0]], np.int64),
                                   5000, 5000)
    assert chain_device.cut_segments(rng).shape[0] > 5
    _device_vs_oracle(ax, ay)


def test_dense_repeat_long_ranges():
    """A repeat cluster: many anchors within one window (flat-kernel path)."""
    rng = np.random.default_rng(7)
    n = 900
    rpos = np.sort(rng.integers(0, 3000, n)).astype(np.uint64)
    # enforce strictly monotone x by adding index (keeps ranges large)
    rpos = rpos + np.arange(n, dtype=np.uint64)
    qpos = (rpos + rng.integers(-200, 200, n).astype(np.int64)).clip(1)
    ay = (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64)
    _device_vs_oracle(rpos, ay)


def test_mg_log2_kernel_matches_host():
    import jax
    import jax.numpy as jnp
    from mm2_gb_tpu.utils.hashkit import mg_log2
    dd = np.concatenate([np.arange(1, 4096),
                         np.random.default_rng(0).integers(1, 2**24, 5000)])
    host = mg_log2((dd + 1).astype(np.float32))
    dev = np.asarray(jax.jit(chain_device._mg_log2_f32)(
        jnp.asarray((dd + 1).astype(np.float32))))
    assert np.array_equal(host, dev)


def test_device_pipeline_matches_host_e2e():
    """map_batch_device (seed→device-chain→backtrack→post) equals the host
    mapper on small reads (interpret mode)."""
    from mm2_gb_tpu.models.index import MinimizerIndex
    from mm2_gb_tpu.models.mapper import map_frag
    from mm2_gb_tpu.models.pipeline import map_batch_device
    from mm2_gb_tpu.utils import opts as O
    from mm2_gb_tpu.utils.fastx import SeqRecord
    from mm2_gb_tpu.utils.paf import write_paf
    from mm2_gb_tpu.utils.simulate import random_reference, simulate_readset

    ref = random_reference(60_000, seed=7)
    reads = simulate_readset(ref, 6, 1_000, 4_000, seed=8)
    io, mo = O.set_preset(None)
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_strings([ref], io, names=["c"])
    O.mapopt_update(mo, index)
    recs = [SeqRecord(i, n, s) for i, (n, s) in enumerate(reads)]
    dev = map_batch_device(index, mo, recs)
    for rec, (sr, regs) in zip(recs, dev):
        host = map_frag(index, mo, [rec.seq], rec.name)
        got = [write_paf(r, rec.name, rec.length, index, mo.flag, sr.rep_len)
               for r in regs]
        want = [write_paf(r, rec.name, rec.length, index, mo.flag,
                          host.rep_len) for r in host.regs]
        assert got == want


def test_oversize_segment_host_fallback(capsys):
    """Segments with ranges far wider than one BLOCK (the old device
    window cap sent these to the host) chain on the device kernel, in
    several BLOCK-wide chunks per anchor, and match the oracle."""
    ax, ay = _synthetic_anchors(1500, 9, step_hi=2)
    bounds = np.array([0, ax.shape[0]], dtype=np.int64)
    rng = chain_device.compute_ranges(ax, bounds, 50000, 40000)
    assert int(rng.max()) > 4 * chain_device.BLOCK
    fd, pd = chain_device.chain_scores_device(ax, ay, bounds, 50000, 50000,
                                              500, 40000, CG, 0.0)
    fo, po = chain_ops._chain_dp_scores(ax, ay, 50000, 50000, 500,
                                        2**31 - 1, 40000, np.float32(CG),
                                        np.float32(0.0), False, 1)
    assert np.array_equal(fo, fd)
    assert np.array_equal(po, pd)
    assert "host" not in capsys.readouterr().err


def test_multichip_chain_matches_oracle():
    """dispatch_batch_multichip over the 8-device CPU mesh (conftest)
    scores each card's anchor-balanced read shard; the collected f/p
    equal the host oracle read by read (zero-collective data
    parallelism, SURVEY.md §5.8)."""
    import jax

    from mm2_gb_tpu.models.index import MinimizerIndex
    from mm2_gb_tpu.models.mapper import _chain_gaps
    from mm2_gb_tpu.models.pipeline import ChainMetrics, seed_read
    from mm2_gb_tpu.parallel.mesh import dispatch_batch_multichip, make_mesh
    from mm2_gb_tpu.utils import opts as O
    from mm2_gb_tpu.utils.fastx import SeqRecord
    from mm2_gb_tpu.utils.simulate import random_reference, simulate_readset

    assert len(jax.devices()) == 8
    ref = random_reference(40_000, seed=21)
    reads = simulate_readset(ref, 16, 300, 900, seed=22)
    io, mo = O.set_preset(None)
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_strings([ref], io, names=["c"])
    O.mapopt_update(mo, index)
    seeded = [seed_read(index, mo, SeqRecord(i, n, q))
              for i, (n, q) in enumerate(reads)]
    met = ChainMetrics()
    _, bounds, pends = dispatch_batch_multichip(index, mo, seeded,
                                                make_mesh(8), met)
    assert len(pends) == 8 and len(met.dev_anchors) == 8
    assert sum(met.dev_anchors.values()) == int(bounds[-1])
    max_gap_qry, max_gap_ref = _chain_gaps(mo, 0)
    cg = np.float32(float(np.float32(mo.chain_gap_scale)) * 0.01 * index.k)
    for pend, s, e in pends:
        fd, pd = pend.collect()
        for i, sr in enumerate(seeded):
            a, b = int(bounds[i]), int(bounds[i + 1])
            if not (s <= a and b <= e) or a == b:
                continue
            fo, po = chain_ops._chain_dp_scores(
                sr.ax, sr.ay, max_gap_ref, max_gap_qry, mo.bw, 2**31 - 1,
                mo.max_chain_iter, cg, np.float32(0.0), False, 1)
            assert np.array_equal(fd[a - s:b - s], fo)
            assert np.array_equal(
                np.where(pd[a - s:b - s] >= 0, pd[a - s:b - s] - (a - s),
                         -1), po)


def test_batch_caps_split_and_match():
    """max_anchors_batch splits the accumulation into multiple device
    batches with overflow spill; output equals the uncapped run."""
    from mm2_gb_tpu.models.index import MinimizerIndex
    from mm2_gb_tpu.models.pipeline import ChainMetrics, map_file_device_records
    from mm2_gb_tpu.utils import opts as O
    from mm2_gb_tpu.utils import devcfg
    from mm2_gb_tpu.utils.paf import write_paf
    from mm2_gb_tpu.utils.simulate import random_reference, simulate_readset
    import tempfile

    ref = random_reference(30_000, seed=11)
    reads = simulate_readset(ref, 4, 600, 1_200, seed=12)
    io, mo = O.set_preset(None)
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_strings([ref], io, names=["c"])
    O.mapopt_update(mo, index)
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        for n, s in reads:
            f.write(f">{n}\n{s}\n")
        qpath = f.name

    def run():
        out = []
        met = ChainMetrics()
        for sr, regs in map_file_device_records(index, mo, [qpath], met):
            for r in regs:
                out.append(write_paf(r, sr.rec.name, sr.rec.length, index,
                                     mo.flag, sr.rep_len))
        return out, met

    base, met0 = run()
    assert met0.n_batches == 1
    old = devcfg._current
    try:
        devcfg._current = devcfg.DeviceConfig(max_anchors_batch=200)
        capped, met1 = run()
    finally:
        devcfg._current = old
    assert met1.n_batches > 1
    assert met1.n_spills > 0
    assert capped == base


def test_multihost_shard_merge(tmp_path):
    """Two-rank --gpu-nproc run: shard outputs + mergeshards equal the
    single-host byte order (SURVEY.md §5.8 deterministic merge)."""
    import os
    import subprocess
    import sys as _sys

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    T = "/root/reference/test"
    if not os.path.isdir(T):
        import pytest
        pytest.skip("reference test data not available")
    ref = os.path.join(T, "MT-human.fa")
    qry = os.path.join(T, "MT-orang.fa")
    base = ["--max-chain-skip=2147483647", "--gpu-chain", ref, qry]
    single = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu", *base],
        capture_output=True, text=True, env=env, timeout=600)
    assert single.returncode == 0
    pre = str(tmp_path / "mh")
    for rank in ("0", "1"):
        r = subprocess.run(
            [_sys.executable, "-m", "mm2_gb_tpu",
             "--max-chain-skip=2147483647", "--gpu-chain",
             "--gpu-nproc", "2", "--gpu-rank", rank, "-o", pre,
             ref, qry],
            capture_output=True, text=True, env=env, timeout=600)
        assert r.returncode == 0, r.stderr[-400:]
    merged = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu.tools.mergeshards", pre, "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert merged.returncode == 0
    assert merged.stdout == single.stdout


def test_multihost_sam_and_truncation_guard(tmp_path):
    """--gpu-nproc with -a: rank 0 carries the SAM header as a
    sort-first idx record and the merged SAM equals single-host bytes;
    a truncated shard body makes mergeshards fail loudly."""
    import os
    import subprocess
    import sys as _sys

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    from tests.conftest import golden_path
    ref = golden_path("splitq_ref.fa.gz")
    qry = golden_path("splitq_q1.fa.gz")  # 12 reads: both ranks get work
    base = ["--max-chain-skip=2147483647", "--gpu-chain", "-a", ref, qry]
    single = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu", *base],
        capture_output=True, text=True, env=env, timeout=600)
    assert single.returncode == 0
    pre = str(tmp_path / "mhs")
    for rank in ("0", "1"):
        r = subprocess.run(
            [_sys.executable, "-m", "mm2_gb_tpu",
             "--max-chain-skip=2147483647", "--gpu-chain", "-a",
             "--gpu-nproc", "2", "--gpu-rank", rank, "-o", pre,
             ref, qry],
            capture_output=True, text=True, env=env, timeout=600)
        assert r.returncode == 0, r.stderr[-400:]
    merged = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu.tools.mergeshards", pre, "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert merged.returncode == 0, merged.stderr[-400:]

    def _no_pg(s):  # @PG CL: carries the (different) argv
        return [l for l in s.splitlines() if not l.startswith("@PG")]
    assert _no_pg(merged.stdout) == _no_pg(single.stdout)

    # truncate rank 1's body: merge must abort, not silently drop reads
    body = open(pre + ".shard1").read()
    open(pre + ".shard1", "w").write(body[:len(body) // 2])
    bad = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu.tools.mergeshards", pre, "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert bad.returncode != 0
    assert "truncated" in bad.stderr or "trailing" in bad.stderr

    # missing sentinel (crashed rank): also a loud failure
    open(pre + ".shard1", "w").write(body)
    idx = open(pre + ".shard1.idx").read().splitlines()
    open(pre + ".shard1.idx", "w").write("\n".join(idx[:-1]) + "\n")
    bad2 = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu.tools.mergeshards", pre, "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert bad2.returncode != 0
    assert "sentinel" in bad2.stderr


def test_multihost_jax_distributed_coordinator(tmp_path):
    """Two CONCURRENT ranks through jax.distributed.initialize (local
    coordinator, CPU backend) via --gpu-coord; shards merge to the
    single-host byte order.  Exercises init_distributed for real
    (SURVEY.md §5.8 pod-slice path)."""
    import os
    import socket
    import subprocess
    import sys as _sys

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    T = "/root/reference/test"
    if not os.path.isdir(T):
        import pytest
        pytest.skip("reference test data not available")
    ref = os.path.join(T, "MT-human.fa")
    qry = os.path.join(T, "MT-orang.fa")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    single = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu",
         "--max-chain-skip=2147483647", "--gpu-chain", ref, qry],
        capture_output=True, text=True, env=env, timeout=600)
    assert single.returncode == 0
    pre = str(tmp_path / "mhd")
    procs = []
    for rank in ("0", "1"):
        procs.append(subprocess.Popen(
            [_sys.executable, "-m", "mm2_gb_tpu",
             "--max-chain-skip=2147483647", "--gpu-chain",
             "--gpu-nproc", "2", "--gpu-rank", rank,
             "--gpu-coord", coord, "-o", pre, ref, qry],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    for pr in procs:
        out, err = pr.communicate(timeout=600)
        assert pr.returncode == 0, err[-600:]
    merged = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu.tools.mergeshards", pre, "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert merged.returncode == 0, merged.stderr[-400:]
    assert merged.stdout == single.stdout


def test_auto_capacity_model(monkeypatch):
    """derive_caps scales the batch caps to the card's memory
    (memory_stats()["bytes_limit"]) via the bytes-per-anchor model
    (plmem.cu:473-540 analog); explicit JSON caps, CPU backends and
    devices that report no memory are left alone."""
    from mm2_gb_tpu.utils import devcfg

    class FakeDev:
        platform = "gpu"
        limit = 60 * 2**30

        def memory_stats(self):
            return {"bytes_limit": self.limit} if self.limit else None

    class FakeJax:
        @staticmethod
        def devices():
            return [FakeDev()]

    monkeypatch.setitem(__import__("sys").modules, "jax", FakeJax)
    monkeypatch.setattr(devcfg, "_current", devcfg.DeviceConfig())
    devcfg.derive_caps(0)
    want = min(int(60 * 2**30 * devcfg.MEM_FRACTION
                   / devcfg.BYTES_PER_ANCHOR),
               devcfg.MAX_AUTO_ANCHORS)  # pipeline-overlap ceiling
    assert devcfg._current.max_anchors_batch == want
    assert devcfg._current.max_reads_batch == max(
        200_000, want // devcfg.AVG_ANCHORS_PER_READ)

    # a device that reports no memory keeps the defaults
    FakeDev.limit = 0
    monkeypatch.setattr(devcfg, "_current", devcfg.DeviceConfig())
    devcfg.derive_caps(0)
    assert devcfg._current == devcfg.DeviceConfig()

    # explicit JSON caps win
    FakeDev.limit = 60 * 2**30
    monkeypatch.setattr(devcfg, "_current", devcfg.DeviceConfig(
        max_anchors_batch=123, caps_explicit=True))
    devcfg.derive_caps(0)
    assert devcfg._current.max_anchors_batch == 123


def test_mergeshards_trailing_loss_and_total_disagreement(tmp_path):
    """Synthetic shards: per-file #file totals let the merge detect
    TRAILING read losses (one rank saw a truncated query file) and
    cross-rank total disagreement — not just interior holes."""
    import subprocess
    import sys as _sys

    def write_rank(rank, recs, total, done=None):
        body, idx = [], []
        for fi, gidx in recs:
            line = f"read{gidx}\tline\n"
            body.append(line)
            idx.append(f"{fi}\t{gidx}\t1")
        idx.append(f"#file\t0\t{total}")
        idx.append(f"#done\t{done if done is not None else len(recs)}")
        open(tmp_path / f"mh.shard{rank}", "w").write("".join(body))
        open(tmp_path / f"mh.shard{rank}.idx", "w").write(
            "\n".join(idx) + "\n")

    # healthy: 4 reads, ranks own evens/odds
    write_rank(0, [(0, 0), (0, 2)], 4)
    write_rank(1, [(0, 1), (0, 3)], 4)
    ok = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu.tools.mergeshards",
         str(tmp_path / "mh"), "2"], capture_output=True, text=True)
    assert ok.returncode == 0
    assert ok.stdout.splitlines() == [f"read{i}\tline" for i in range(4)]

    # trailing loss: rank 1 only saw 2 reads (truncated file copy) but
    # wrote a valid sentinel; union {0,1,2} vs total 4
    write_rank(1, [(0, 1)], 2)
    bad = subprocess.run(
        [_sys.executable, "-m", "mm2_gb_tpu.tools.mergeshards",
         str(tmp_path / "mh"), "2"], capture_output=True, text=True)
    assert bad.returncode != 0
    assert "disagree" in bad.stderr or "missing" in bad.stderr
