"""The chain kernel's wrapper and its interpret-mode runs on the CPU.

Kernel-vs-oracle cases run the Pallas (Triton) kernel in interpret mode
(conftest puts the suite on the CPU); the `gpu`-marked tests run the
same checks compiled, and skip without a card.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from mm2_gb_tpu.ops import chain as chain_ops
from mm2_gb_tpu.ops import chain_device as CD
from mm2_gb_tpu.tools import kernel_check as KC

CG = float(np.float32(float(np.float32(0.8)) * 0.01 * 15))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(n, seed, step_hi=12, jitter=6, rev=False, rid=0, span=15):
    rng = np.random.default_rng(seed)
    rpos = np.cumsum(rng.integers(1, step_hi, n))
    qpos = np.maximum.accumulate(
        np.maximum(rpos + rng.integers(-jitter, jitter + 1, n), 1))
    hi = (np.uint64(rev) << np.uint64(63)) | (np.uint64(rid) << np.uint64(32))
    return (hi | rpos.astype(np.uint64),
            (np.uint64(span) << np.uint64(32)) | qpos.astype(np.uint64))


def _batch(reads, max_dist=5000, bw=500, max_iter=5000):
    ax = np.concatenate([r[0] for r in reads])
    ay = np.concatenate([r[1] for r in reads])
    bounds = np.cumsum([0] + [r[0].shape[0] for r in reads]).astype(np.int64)
    return KC.Batch(ax, ay, bounds, max_dist, max_dist, bw, max_iter, CG,
                    len(reads))


CASES = {
    "two_anchors": lambda: _batch([_read(2, 0)]),
    "one_block": lambda: _batch([_read(300, 1, step_hi=4)],
                                max_iter=CD.BLOCK),
    "block_plus_one": lambda: _batch([_read(300, 2, step_hi=4)],
                                     max_iter=CD.BLOCK + 1),
    "dense_repeat": lambda: _batch([_read(700, 3, step_hi=2, jitter=40)],
                                   max_iter=600),
    "regular_ties": lambda: _batch([_read(400, 4, step_hi=2, jitter=0)]),
    "multi_segment": lambda: _batch([
        (np.concatenate([_read(60, s)[0] + np.uint64(s * 100_000)
                         for s in range(5)]),
         np.concatenate([_read(60, s)[1] for s in range(5)]))]),
    "reads_strands_rids": lambda: _batch([
        _read(90, 5), _read(80, 6, rev=True), _read(70, 7, rid=3),
        _read(1, 8), _read(120, 9, rev=True, rid=1)]),
    "narrow_y_window": lambda: dataclasses.replace(
        _batch([_read(300, 10, step_hi=30, jitter=300)]), max_dist_y=700),
    "part_boundary": lambda: _batch([
        _read(CD.INTERPRET_PART - 10, 11, step_hi=300),
        _read(200, 12, step_hi=4)]),
}


@pytest.mark.parametrize("is_cdna", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_oracle(case, is_cdna):
    res = KC.check(CASES[case](), is_cdna=is_cdna)
    assert res["exact"], res


def test_wide_gaps_keep_float_rounding():
    """dd up to 2^24 with both penalty products live: an FMA anywhere
    in the penalty would change some score (the _nofma pins)."""
    b = KC.wide_gap_batch()
    dd = np.abs(np.diff(b.ax.astype(np.int64))
                - np.diff((b.ay & np.uint64(0xFFFFFFFF)).astype(np.int64)))
    assert dd.max() > 2**17
    res = KC.check(b, cs=0.3)
    assert res["exact"], res
    assert res["pairs"] > 0


def test_mg_log2_sweep():
    assert KC.mg_log2_sweep()


def test_mixed_spans_chain_on_host():
    """HPC-style mixed minimizer spans: the batch chains on the host
    (the reference GPU path's fixed-span restriction) and is counted."""
    from mm2_gb_tpu.models.pipeline import ChainMetrics
    ax, ay = _read(200, 13)
    ay = ay.copy()
    ay[::3] = (ay[::3] & np.uint64(0xFFFFFFFF)) | (np.uint64(14)
                                                  << np.uint64(32))
    met = ChainMetrics()
    bounds = np.array([0, 200], np.int64)
    f, p = CD.dispatch_scores(ax, ay, bounds, 5000, 5000, 500, 5000, CG,
                              0.0, metrics=met).collect()
    fo, po = chain_ops._chain_dp_scores(ax, ay, 5000, 5000, 500, 2**31 - 1,
                                        5000, np.float32(CG),
                                        np.float32(0.0), False, 1)
    assert np.array_equal(f, fo) and np.array_equal(p, po)
    assert met.n_host_segs == met.n_segs > 0 and met.n_dispatch == 0


def test_plan_programs_longest_first():
    bounds = np.array([0, 1, 5, 6, 16, 18, 19], np.int64)
    lo, hi = CD.plan_programs(bounds)
    assert lo.tolist() == [6, 1, 16] and hi.tolist() == [16, 5, 18]
    assert lo.dtype == np.int32


def test_plan_programs_all_lone_anchors():
    lo, hi = CD.plan_programs(np.arange(6, dtype=np.int64))
    assert lo.shape == hi.shape == (0,)


@pytest.mark.parametrize("limit", [None, 1, 7, 100])
def test_parts_cover_whole_segments(limit):
    bounds = np.array([0, 3, 4, 12, 20, 21, 40], np.int64)
    parts = CD._parts(bounds, limit)
    assert parts[0][0] == 0 and parts[-1][1] == 40
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert all(s in bounds and e in bounds for s, e in parts)
    if limit is None:
        assert parts == [(0, 40)]


@pytest.mark.parametrize("n,want", [(1, 2048), (2048, 2048), (2049, 2560),
                                    (5000, 5120), (1 << 20, 1 << 20),
                                    ((1 << 20) + 1, 1310720)])
def test_quant_size(n, want):
    assert CD._quant_size(n) == want
    assert want >= n and want <= max(2048, 1.25 * n + 1)


def test_pending_scores_offsets_parts():
    """Results of several parts land at their batch offsets, with
    predecessors shifted to batch indices."""
    pend = CD.PendingScores(6)
    pend.parts = [(0, 2, (np.array([7, 8, 0]), np.array([-1, 0, 0]))),
                  (2, 6, (np.array([9, 10, 11, 12]),
                          np.array([-1, 0, 1, -1])))]
    f, p = pend.collect()
    assert f.tolist() == [7, 8, 9, 10, 11, 12]
    assert p.tolist() == [-1, 0, -1, 2, 3, -1]
    assert pend.parts == []


@pytest.mark.parametrize("backend,want", [("gpu", False), ("cpu", True),
                                          ("tpu", None)])
def test_use_interpret(monkeypatch, backend, want):
    """Compiled on a GPU, interpreter only on an explicitly chosen CPU,
    an error anywhere else."""
    monkeypatch.setattr(CD.jax, "default_backend", lambda: backend)
    if want is None:
        with pytest.raises(CD.NoDeviceError, match="needs an NVIDIA GPU"):
            CD.use_interpret()
    else:
        assert CD.use_interpret() is want


def test_gpu_chain_without_gpu_fails(tmp_path):
    """With JAX_PLATFORMS unset and no GPU, --gpu-chain exits non-zero
    with a clear message instead of falling back."""
    from tests.conftest import golden_path
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run(
        [sys.executable, "-m", "mm2_gb_tpu", "--gpu-chain",
         golden_path("simref.fa.gz"), golden_path("pe_1.fq.gz")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    if r.returncode == 0 and "[M::gpu]" in r.stderr:
        pytest.skip("this host has a GPU")
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert r.stdout == ""


def test_compile_cache_dir_env_set(tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins: compiled programs land there and
    the program sets no other directory."""
    cache = tmp_path / "jc"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache))
    code = ("import jax, jax.numpy as jnp\n"
            "from mm2_gb_tpu.utils.devcfg import enable_compile_cache\n"
            "d = enable_compile_cache()\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0)\n"
            "jax.jit(lambda x: x * 3 + 1)(jnp.arange(5)).block_until_ready()\n"
            "print(d, jax.config.jax_compilation_cache_dir)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-1000:]
    assert r.stdout.split() == [str(cache), str(cache)]
    assert any(cache.iterdir())


def test_compile_cache_dir_env_unset(monkeypatch):
    """Without the variable the cache sits at a fixed directory in the
    checkout (never under ~ and never a per-process name)."""
    from mm2_gb_tpu.utils import devcfg
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert devcfg.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    assert devcfg.compile_cache_dir() == devcfg.compile_cache_dir()


@pytest.mark.parametrize("name,value", [
    ("chain", None), ("devices", "4"), ("nproc", "2"), ("rank", "1"),
    ("coord", "localhost:1234"), ("profile", "prof"), ("cfg", "c.json")])
def test_tpu_spellings_are_hidden_aliases(name, value):
    from mm2_gb_tpu.cli import build_parser
    p = build_parser()
    extra = [] if value is None else [value]
    new = vars(p.parse_args([f"--gpu-{name}", *extra, "ref.fa"]))
    old = vars(p.parse_args([f"--tpu-{name}", *extra, "ref.fa"]))
    assert new == old
    assert new[f"gpu_{name}"] == (True if value is None else
                                  type(new[f"gpu_{name}"])(value))
    assert f"--tpu-{name}" not in p.format_help()
    assert f"--gpu-{name}" in p.format_help()


@pytest.mark.gpu
def test_gpu_kernel_matches_oracle(gpu):
    """Compiled kernel on the card vs the oracle: a small flowcell
    batch, its is_cdna variant, the wide-gap rounding batch and the
    mg_log2 sweep (chip_smoke.py runs these at full batch width)."""
    b = KC.sample_batch(4_000_000, 30, 20, 10_000, 50_000, 7, 400_000)
    assert KC.check(b)["exact"]
    assert KC.check(b, is_cdna=True)["exact"]
    assert KC.check(KC.wide_gap_batch(), cs=0.3)["exact"]
    assert KC.mg_log2_sweep()
