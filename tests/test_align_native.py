"""Native alignment driver (csrc/alignkit.cpp::mmt_align1) vs the Python
oracle (ops/align.py::_align1).

The Python _align1 is the validated byte-exact analog of mm_align1
(align.c:573-826); the C++ driver must produce identical output on every
workload.  These tests run the SAME mapping twice — native gate on and
forced off — and require byte-identical PAF/SAM, covering Z-drop splits,
inversion rescue, eqx, HPC presets and short-read mode."""

import numpy as np
import pytest

from mm2_gb_tpu.models.index import MinimizerIndex
from mm2_gb_tpu.models.mapper import map_frag
from mm2_gb_tpu.ops import align as align_mod
from mm2_gb_tpu.utils import native
from mm2_gb_tpu.utils import opts as O
from mm2_gb_tpu.utils.fastx import SeqRecord
from mm2_gb_tpu.utils.paf import write_paf
from mm2_gb_tpu.utils.simulate import random_reference, simulate_readset

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native kit unavailable")


def _map_all(index, mo, reads, force_python):
    out = []
    orig = align_mod._native_align1_ok
    if force_python:
        align_mod._native_align1_ok = lambda *_: False
    try:
        for name, seq in reads:
            res = map_frag(index, mo, [seq], name)
            for r in res.regs:
                out.append(write_paf(r, name, len(seq), index,
                                     mo.flag, res.rep_len, None, seq))
    finally:
        align_mod._native_align1_ok = orig
    return "\n".join(out)


def _setup(preset, flags_extra=0, ref_len=300_000, n_reads=30,
           lo=1_000, hi=20_000, seed=7, mut=None):
    ref = random_reference(ref_len, seed=seed)
    reads = simulate_readset(ref, n_reads, lo, hi, seed=seed + 1)
    if mut:
        reads = mut(ref, reads)
    io, mo = O.set_preset(preset)
    mo.flag |= O.MM_F_CIGAR | flags_extra
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_strings([ref], io, names=["chr1"])
    O.mapopt_update(mo, index)
    return index, mo, reads


@pytest.mark.parametrize("preset", [None, "map-ont", "map-pb", "map-hifi",
                                    "asm5", "sr"])
def test_native_align1_matches_oracle(preset):
    """Byte-identical PAF across presets (map-pb exercises HPC minimizer
    re-adjustment, sr the ungapped short-read fill, asm5 dual gap costs)."""
    index, mo, reads = _setup(preset, n_reads=15, hi=8_000)
    a = _map_all(index, mo, reads, force_python=False)
    b = _map_all(index, mo, reads, force_python=True)
    assert a == b


def test_native_align1_eqx():
    index, mo, reads = _setup("map-ont", flags_extra=O.MM_F_EQX,
                              n_reads=10, hi=6_000)
    a = _map_all(index, mo, reads, force_python=False)
    b = _map_all(index, mo, reads, force_python=True)
    assert a == b and "=" not in ""  # eqx cigars compared inside PAF


def test_native_align1_zdrop_split_and_inversion():
    """Structural reads: an inverted mid-segment forces Z-drop splits and
    the inversion-rescue path (split_reg float staging, align.c:761-781)."""
    def mut(ref, reads):
        out = []
        comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
        for i, (name, seq) in enumerate(reads):
            if len(seq) > 6000:
                a, b = len(seq) // 3, 2 * len(seq) // 3
                inv = "".join(comp.get(c, "N") for c in reversed(seq[a:b]))
                seq = seq[:a] + inv + seq[b:]
            out.append((name, seq))
        return out
    index, mo, reads = _setup("map-ont", n_reads=12, lo=5_000, hi=15_000,
                              seed=19, mut=mut)
    a = _map_all(index, mo, reads, force_python=False)
    b = _map_all(index, mo, reads, force_python=True)
    assert a == b


def test_native_align1_indel_dense():
    """Indel-dense reads exercise filter_bad_seeds/long-join marking and
    the CIGAR left-shift/merge normalization (mm_fix_cigar)."""
    def mut(ref, reads):
        rng = np.random.default_rng(3)
        out = []
        for name, seq in reads:
            s = list(seq)
            for _ in range(len(s) // 200):
                p = int(rng.integers(10, len(s) - 60))
                if rng.random() < 0.5:
                    del s[p:p + int(rng.integers(5, 50))]
                else:
                    ins = "".join("ACGT"[c] for c in
                                  rng.integers(0, 4, int(rng.integers(5, 50))))
                    s.insert(p, ins)
            out.append((name, "".join(s)))
        return out
    index, mo, reads = _setup("map-ont", n_reads=12, lo=3_000, hi=10_000,
                              seed=23, mut=mut)
    a = _map_all(index, mo, reads, force_python=False)
    b = _map_all(index, mo, reads, force_python=True)
    assert a == b
