"""Benchmark: GPU chain kernel throughput + end-to-end --gpu-chain vs the
host path.

    python bench.py [N_READS]      # default 1000 reads

Kernel stage (a child process, the only one that touches the card): a
full macro-batch of the ONT flowcell at the auto batch cap (10-100 kb
reads against a 100 Mbp repeat-planted reference, seeded by the real
seeding path) is scored on the device path and required to equal the
host oracle exactly; then the chain kernel alone is timed on
device-resident operands (median of 5 after a compiling call) — the
reference's own Mpairs/s methodology, which times the score kernels with
device events and excludes host packing and transfers
(gpu/planalyze.cu:59-86).

E2E stage: the CLI maps the N-read flowcell with and without
--gpu-chain in the same run, at -t = all cores; wall time, reads/s and
byte equality of the two outputs.

Fails (non-zero exit, no result) without a GPU.  Prints the card's name
and power limit, then one JSON line last.
"""

import json
import os
import subprocess
import sys

import chip_smoke as S


def kernel_child() -> None:
    from mm2_gb_tpu.tools import kernel_check as KC
    from mm2_gb_tpu.utils import devcfg
    dev = S.child_env()
    devcfg.derive_caps(0)
    b = KC.sample_batch(100_000_000, 750, 1000, 10_000, 100_000, 1,
                        devcfg.current_config().max_anchors_batch)
    res = KC.check(b)
    if not res["exact"]:
        S.fail(f"device chain scores differ from the host oracle: {res}")
    t = KC.kernel_time(b)
    print(json.dumps({
        "device": dev, "kernel_anchors": res["anchors"],
        "kernel_pairs": res["pairs"],
        "kernel_longest_segment": res["longest_segment"],
        "kernel_ms": t["kernel_s"] * 1e3,
        "kernel_first_call_s": t["first_call_s"],
        "value": t["pairs_per_s"] / 1e9}), flush=True)


def main() -> int:
    if sys.argv[1:] == ["--kernel"]:
        kernel_child()
        return 0
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    smi = S.nvidia_smi()
    r = subprocess.run([sys.executable, __file__, "--kernel"], cwd=S.ROOT,
                       stdout=subprocess.PIPE, text=True,
                       timeout=S.remaining())
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        print("\n".join(lines))
        S.fail(f"kernel stage exited {r.returncode}")
    result = {"metric": "chain_kernel_throughput", "unit": "Gpairs/s",
              "card": smi, **json.loads(lines[-1])}

    from mm2_gb_tpu.utils.simulate import materialize_flowcell
    ref, reads = materialize_flowcell(n_reads, S.WORK)
    common = ["--max-chain-skip=2147483647", "-t",
              str(os.cpu_count() or 1), "-x", "map-ont", ref, reads]
    host_out = os.path.join(S.WORK, "bench.host.out")
    gpu_out = os.path.join(S.WORK, "bench.gpu.out")
    wall_h, _ = S.run_cli(common, host_out)
    wall_g, _ = S.run_cli(["--gpu-chain"] + common, gpu_out)
    with open(host_out, "rb") as a, open(gpu_out, "rb") as b:
        same = a.read() == b.read()
    result.update({"e2e_n_reads": n_reads, "e2e_host_wall_s": wall_h,
                   "e2e_gpu_wall_s": wall_g,
                   "e2e_host_reads_s": n_reads / wall_h,
                   "e2e_gpu_reads_s": n_reads / wall_g,
                   "e2e_byte_match": same})
    if not same:
        S.fail("--gpu-chain output differs from the host path")
    print(f"nvidia-smi: {smi}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
