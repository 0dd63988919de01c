"""Thread-count determinism at flowcell scale (VERDICT r3 item #7).

The reference ships tsan as a build mode (Makefile:33-41) to guard its
kt_for pipeline; the analog here is a byte-identity gate over the two
threaded runtimes this package has — the host pipeline's map pool
(models/stream.py) and the device pipeline's fan-out finish
(models/pipeline.py finish_slices) — run at -t 1/4/8 on a simulated
flowcell.  Output order and bytes must not depend on scheduling.

Scale knob (CI runs bigger than the default local suite):
  MM2TPU_DET_READS   host flowcell size        [96]
The device pipeline runs its chain kernel in interpret mode here, so it
is gated on a 16-read prefix of the same flowcell.
"""

import contextlib
import io
import os

import pytest

N_READS = int(os.environ.get("MM2TPU_DET_READS", "96"))


@pytest.fixture(scope="module")
def flowcell(tmp_path_factory):
    from mm2_gb_tpu.utils.simulate import random_reference, simulate_readset
    d = tmp_path_factory.mktemp("det")
    ref = random_reference(400_000, seed=11)
    reads = simulate_readset(ref, N_READS, 2_000, 12_000, seed=12)
    ref_fa = d / "ref.fa"
    reads_fa = d / "reads.fa"
    with open(ref_fa, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(ref), 80):
            f.write(ref[i:i + 80] + "\n")
    with open(reads_fa, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")
    return str(ref_fa), str(reads_fa)


def _run_cli(argv) -> str:
    from mm2_gb_tpu import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0
    return buf.getvalue()


def _norm(out: str) -> str:
    """Drop the @PG header line: its CL: field embeds the -t value by
    design (format.c:118 echoes argv), everything else must be
    byte-identical."""
    return "\n".join(ln for ln in out.split("\n")
                     if not ln.startswith("@PG\t"))


@pytest.mark.parametrize("extra", [[], ["-c"], ["-a"]])
def test_host_pipeline_thread_independent(flowcell, extra):
    ref_fa, reads_fa = flowcell
    outs = [_norm(_run_cli(["--max-chain-skip=2147483647", "-t", str(t),
                            *extra, ref_fa, reads_fa]))
            for t in (1, 4, 8)]
    assert outs[0], "empty mapping output"
    assert outs[0] == outs[1] == outs[2]


def test_tpu_pipeline_thread_independent(flowcell, tmp_path):
    """--gpu-chain's fan-out finish (ordered emit) at -t 1/4/8."""
    ref_fa, all_fa = flowcell
    reads_fa = str(tmp_path / "reads16.fa")
    with open(all_fa) as f, open(reads_fa, "w") as g:
        g.writelines(f.readlines()[:32])
    outs = [_run_cli(["--max-chain-skip=2147483647", "--gpu-chain", "-t",
                      str(t), "-c", ref_fa, reads_fa])
            for t in (1, 4, 8)]
    assert outs[0], "empty mapping output"
    assert outs[0] == outs[1] == outs[2]
