#!/usr/bin/env python3
"""Smoke test of the mapper's GPU path on an NVIDIA card.

    python chip_smoke.py              # one card: kernel + end-to-end phases
    python chip_smoke.py --multi-gpu  # four cards: --gpu-devices 4 only

Phases, each of which must pass:

1. Environment: the card's name and power limit (nvidia-smi), the JAX
   version, its devices and the compile-cache directory.  Fails unless
   JAX runs on a GPU.
2. Kernel (one card): the chain kernel, compiled for the card, against
   the host oracle (ops/chain._chain_dp_scores) with exact equality of
   f and p: a full macro-batch of the ONT flowcell at the auto batch
   cap, its is_cdna (splice) variant, the ultra-long batch, a batch of
   gaps up to 2^24 (no FMA contraction) and the mg_log2 sweep.
3. End to end (one card): the CLI with --gpu-chain and then without it
   on the same input; the outputs must be byte-identical.  Workloads,
   all generated from fixed seeds: map-ont on 1000 reads of 10-100 kb
   against a 100 Mbp reference, the 40-read ultra-long set, -x splice on
   the in-repo splice goldens' inputs, and -c on the flowcell.

With --multi-gpu only the data-parallel path runs: the flowcell with
--gpu-devices 4 and 1, each byte-compared with the host path, with
reads/s and the anchors per card.

The parent process never starts JAX (a JAX process reserves most of a
card's memory); each phase that needs the card runs in its own child,
one at a time.  Inputs and outputs go to .smoke/ in the checkout.  The
last line of standard output is the JSON result, printed only when
every phase passed; any failure exits non-zero.
"""

from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
BUDGET_S = 1150.0
T0 = time.monotonic()


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    say(f"chip_smoke: FAIL: {msg}")
    sys.exit(1)


def remaining() -> float:
    left = BUDGET_S - (time.monotonic() - T0)
    if left <= 0:
        fail("out of time")
    return left


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return r.stdout.strip() or f"unavailable (rc {r.returncode})"


# --------------------------------------------------------------------------
# children (the only processes that touch the card)
# --------------------------------------------------------------------------

def child_env() -> dict:
    import jax

    from mm2_gb_tpu.utils.devcfg import enable_compile_cache
    cache = enable_compile_cache()
    devs = jax.devices()
    say(f"env: nvidia-smi {nvidia_smi()}; jax {jax.__version__}; "
        f"devices {devs}; compile cache {cache}")
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    if dev["platform"] != "gpu":
        fail(f"JAX runs on '{dev['platform']}', not on a GPU")
    return dev


def child_kernel() -> dict:
    dev = child_env()
    from mm2_gb_tpu.tools import kernel_check as KC
    from mm2_gb_tpu.utils import devcfg

    devcfg.derive_caps(0)
    cap = devcfg.current_config().max_anchors_batch
    ok = True

    def report(name: str, res: dict) -> None:
        nonlocal ok
        ok &= res["exact"]
        say(f"kernel {name}: exact={res['exact']} "
            f"(mismatches {res['mismatches']}), {res['reads']} reads, "
            f"{res['anchors']} anchors, {res['segments']} segments "
            f"(longest {res['longest_segment']}), {res['pairs']} pairs, "
            f"host-fallback segments {res['host_segments']}, device path "
            f"{res['device_path_s']:.3f}s, oracle {res['oracle_s']:.3f}s")

    fc = KC.sample_batch(100_000_000, 750, 1000, 10_000, 100_000, 1, cap)
    report(f"map-ont flowcell batch (cap {cap} anchors)", KC.check(fc))
    t = KC.kernel_time(fc)
    say(f"kernel map-ont flowcell time: {t['kernel_s'] * 1e3:.2f} ms "
        f"(median of {len(t['times_s'])}, first call "
        f"{t['first_call_s']:.2f}s), {t['pairs_per_s'] / 1e9:.2f} "
        "Gpairs/s")
    report("map-ont flowcell batch, is_cdna", KC.check(fc, is_cdna=True))
    del fc
    ul = KC.sample_batch(8_000_000, 60, 40, 100_000, 300_000, 11, cap)
    report("ultra-long batch", KC.check(ul))
    t = KC.kernel_time(ul)
    say(f"kernel ultra-long time: {t['kernel_s'] * 1e3:.2f} ms, "
        f"{t['pairs_per_s'] / 1e9:.2f} Gpairs/s")
    del ul
    report("wide gaps to 2^24 (cs=0.3)",
           KC.check(KC.wide_gap_batch(), cs=0.3))
    sweep = KC.mg_log2_sweep()
    say(f"kernel mg_log2 sweep to 2^24: exact={sweep}")
    if not (ok and sweep):
        fail("device scores differ from the host oracle")
    return dev


def run_child(mode: str) -> dict:
    say(f"--- phase: {mode} (child process)")
    try:
        r = subprocess.run([sys.executable, __file__, "--child", mode],
                           cwd=ROOT, stdout=subprocess.PIPE, text=True,
                           timeout=remaining())
    except subprocess.TimeoutExpired:
        fail(f"phase {mode} ran out of time")
    lines = r.stdout.strip().splitlines()
    for ln in lines[:-1]:
        say(ln)
    if r.returncode != 0 or not lines:
        say(lines[-1] if lines else "")
        fail(f"phase {mode} exited {r.returncode}")
    return json.loads(lines[-1])


# --------------------------------------------------------------------------
# end to end through the CLI
# --------------------------------------------------------------------------

def run_cli(args: list[str], out: str) -> tuple[float, str]:
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m", "mm2_gb_tpu", "-o", out,
                            *args], cwd=ROOT, capture_output=True,
                           text=True, timeout=remaining())
    except subprocess.TimeoutExpired:
        fail(f"CLI ran out of time: {' '.join(args)}")
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        say(r.stderr[-3000:])
        fail(f"CLI exited {r.returncode}: {' '.join(args)}")
    return wall, r.stderr


def e2e(name: str, args: list[str], n_reads: int,
        devices: tuple[int, ...] = (0,)) -> None:
    """Host path, then --gpu-chain (with --gpu-devices d for each d > 0);
    every device output must equal the host output byte for byte."""
    threads = str(os.cpu_count() or 1)
    common = ["--max-chain-skip=2147483647", "-t", threads, *args]
    host_out = os.path.join(WORK, f"{name}.host.out")
    wall_h, err = run_cli(common, host_out)
    say(f"e2e {name} host path: wall {wall_h:.2f}s, "
        f"{n_reads / wall_h:.2f} reads/s (-t {threads})")
    for ln in err.splitlines():
        if ln.startswith("[M::pipeline]"):
            say(f"    {ln}")
    for d in devices:
        extra = ["--gpu-chain"] + (["--gpu-devices", str(d)] if d else [])
        tag = f"gpu{d}" if d else "gpu"
        out = os.path.join(WORK, f"{name}.{tag}.out")
        wall, err = run_cli(extra + common, out)
        same = filecmp.cmp(out, host_out, shallow=False)
        say(f"e2e {name} --gpu-chain{' --gpu-devices %d' % d if d else ''}:"
            f" wall {wall:.2f}s, {n_reads / wall:.2f} reads/s, "
            f"byte-identical to host: {same}")
        for ln in err.splitlines():
            if ln.startswith("[M::gpu]") or ln.startswith("[M::devcfg]"):
                say(f"    {ln}")
        if not same:
            fail(f"{name}: --gpu-chain output differs from the host path")


def golden(name: str) -> str:
    return os.path.join(ROOT, "tests", "golden", name)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        dev = {"env": child_env, "kernel": child_kernel}[sys.argv[2]]()
        say(json.dumps(dev))
        return 0
    multi = sys.argv[1:] == ["--multi-gpu"]
    if sys.argv[1:] not in ([], ["--multi-gpu"]):
        fail(f"usage: {sys.argv[0]} [--multi-gpu]")
    if not os.path.isdir(os.path.join(ROOT, "mm2_gb_tpu")):
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, ROOT)
    from mm2_gb_tpu.utils.simulate import (materialize_flowcell,
                                           materialize_ultralong)
    smi = nvidia_smi()
    say(f"card: {smi}")

    if multi:
        dev = run_child("env")
        if dev["count"] < 4:
            fail(f"--multi-gpu needs 4 cards, JAX sees {dev['count']}")
        say("--- phase: multi-GPU end to end")
        ref, reads = materialize_flowcell(1000, WORK)
        e2e("map-ont-4gpu", ["-x", "map-ont", ref, reads], 1000,
            devices=(4, 1))
        dev["count"] = 4
    else:
        dev = run_child("kernel")
        say("--- phase: end to end")
        ref, reads = materialize_flowcell(1000, WORK)
        e2e("map-ont", ["-x", "map-ont", ref, reads], 1000)
        ul_ref, ul_reads = materialize_ultralong(40, WORK)
        e2e("ultra-long", ["-x", "map-ont", ul_ref, ul_reads], 40)
        e2e("splice", ["-x", "splice", golden("splice_genome.fa.gz"),
                       golden("splice_reads.fa.gz")], 40)
        e2e("map-ont-c", ["-x", "map-ont", "-c", ref, reads], 1000)
    say(f"total {time.monotonic() - T0:.1f}s")
    say(f"nvidia-smi: {smi}")
    say(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
