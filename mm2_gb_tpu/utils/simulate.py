"""Synthetic read simulation for benchmarks and tests.

Generates a random reference and ONT-like reads with substitutions and
indels — the anchor statistics (density, gap structure) approximate the
10–100 kb nanopore workload the reference benchmarks against
(BASELINE.md configs).
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_reference(length: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    return rng.choice(_BASES, length).tobytes().decode()


def simulate_read(ref: str, start: int, length: int, *, sub_rate=0.04,
                  ins_rate=0.005, del_rate=0.005, rev=False,
                  seed: int = 0) -> str:
    """One noisy read from ref[start:start+length]."""
    rng = np.random.default_rng(seed)
    frag = np.frombuffer(ref[start:start + length].encode(), np.uint8).copy()
    # substitutions
    sub = rng.random(frag.shape[0]) < sub_rate
    frag[sub] = _BASES[rng.integers(0, 4, int(sub.sum()))]
    # deletions
    keep = rng.random(frag.shape[0]) >= del_rate
    frag = frag[keep]
    # insertions
    ins = rng.random(frag.shape[0]) < ins_rate
    n_ins = int(ins.sum())
    if n_ins:
        pos = np.nonzero(ins)[0]
        frag = np.insert(frag, pos, _BASES[rng.integers(0, 4, n_ins)])
    seq = frag.tobytes().decode()
    if rev:
        from mm2_gb_tpu.utils.fastx import revcomp
        seq = revcomp(seq)
    return seq


def simulate_readset(ref: str, n_reads: int, min_len: int, max_len: int,
                     seed: int = 0, **noise) -> list[tuple[str, str]]:
    """Returns [(name, seq)] with lengths uniform in [min_len, max_len]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        ln = int(rng.integers(min_len, max_len + 1))
        ln = min(ln, len(ref) - 1)
        st = int(rng.integers(0, len(ref) - ln))
        rev = bool(rng.integers(0, 2))
        seq = simulate_read(ref, st, ln, rev=rev, seed=seed * 100003 + i,
                            **noise)
        out.append((f"read{i}_{st}_{ln}{'-' if rev else '+'}", seq))
    return out


def random_repetitive_reference(length: int, seed: int = 11,
                                n_arrays: int = 60) -> str:
    """Random reference with planted tandem-repeat arrays.

    Reads crossing an array produce quadratic anchor blowups (every
    query copy hits every reference copy), which is what populates
    chain-segment successor ranges ABOVE the small window class — the
    workload the reference's over50k GPU config exists for
    (gpu/mi210_over50k_config.json)."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(_BASES, length).copy()
    for _ in range(n_arrays):
        unit_len = int(rng.integers(300, 800))
        copies = int(rng.integers(10, 16))   # below typical mid_occ
        unit = _BASES[rng.integers(0, 4, unit_len)]
        arr = np.tile(unit, copies)
        mut = rng.random(arr.shape[0]) < 0.005   # light per-copy divergence
        arr[mut] = _BASES[rng.integers(0, 4, int(mut.sum()))]
        pos = int(rng.integers(0, length - arr.shape[0] - 1))
        ref[pos:pos + arr.shape[0]] = arr
    return ref.tobytes().decode()


def _write_fasta(path: str, records) -> None:
    """Write [(name, seq)] as FASTA (80-column lines), atomically."""
    import os
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            f.write("\n".join(seq[i:i + 80]
                              for i in range(0, len(seq), 80)))
            f.write("\n")
    os.replace(tmp, path)


def _materialize(d: str, make_ref, n_reads: int, min_len: int,
                 max_len: int, seed: int) -> tuple[str, str]:
    import os
    os.makedirs(d, exist_ok=True)
    ref_fa = os.path.join(d, "ref.fa")
    reads_fa = os.path.join(d, "reads.fa")
    if not (os.path.exists(ref_fa) and os.path.exists(reads_fa)):
        ref = make_ref()
        reads = simulate_readset(ref, n_reads, min_len, max_len, seed=seed)
        _write_fasta(ref_fa, [("chr1", ref)])
        _write_fasta(reads_fa, reads)
    return ref_fa, reads_fa


def materialize_ultralong(n_reads: int, base_dir: str) -> tuple[str, str]:
    """Ultra-long repeat-rich flowcell under base_dir: an 8 Mbp
    reference with tandem arrays + 100-300 kb reads (the reference's
    over50k case), whose segments reach the 5000-anchor range cap."""
    import os
    return _materialize(
        os.path.join(base_dir, f"ul{n_reads}"),
        lambda: random_repetitive_reference(8_000_000, seed=11), n_reads,
        100_000, 300_000, seed=12)


def materialize_flowcell(n_reads: int, base_dir: str) -> tuple[str, str]:
    """Write (and keep on disk under base_dir) the standard ONT flowcell:
    a 100 Mbp reference with planted tandem arrays (the ultra-long
    reference's repeat density) and `n_reads` 10-100 kb ONT-like reads.
    The directory is keyed on n_reads so sizes never clobber each
    other."""
    import os
    return _materialize(
        os.path.join(base_dir, f"fc{n_reads}"),
        lambda: random_repetitive_reference(100_000_000, seed=1,
                                            n_arrays=750),
        n_reads, 10_000, 100_000, seed=3)
