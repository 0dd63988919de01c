"""ksw2 DP kernels vs golden outputs from the reference SSE kernels.

Cases in tests/golden/ksw2_cases.json were produced by running the
reference ksw_extz2_sse / ksw_extd2_sse / ksw_ll_i16 (SSE4.1 build) on
randomized sequence pairs covering every (flag, band, zdrop, end_bonus)
combination the mapper uses (align.c:316-342,700-803).
"""

import json

import numpy as np
import pytest

from mm2_gb_tpu.ops import ksw2
from tests.conftest import golden_path

CIG = "MIDN"


def _fmt(ez: ksw2.Extz) -> str:
    cig = "".join(f"{int(c) >> 4}{CIG[int(c) & 0xF]}" for c in ez.cigar)
    return (f"{ez.score} {ez.max} {ez.max_q} {ez.max_t} {ez.mqe} {ez.mqe_t} "
            f"{ez.mte} {ez.mte_q} {int(ez.zdropped)} {int(ez.reach_end)} "
            f"{cig if cig else '*'}")


def _cases():
    with open(golden_path("ksw2_cases.json")) as f:
        return json.load(f)


CASES = _cases()


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_ksw2_case(idx):
    c = CASES[idx]
    qseq = np.frombuffer(c["qseq"].encode(), np.uint8) - ord("0")
    tseq = np.frombuffer(c["tseq"].encode(), np.uint8) - ord("0")
    mat = ksw2.gen_simple_mat(5, c["a"], c["b"], c["sc_ambi"])
    if c["kind"] == 0:
        ez = ksw2.extz2(qseq, tseq, mat, c["q"], c["e"], c["w"], c["zdrop"],
                        c["end_bonus"], c["flag"])
        assert _fmt(ez) == c["golden"], f"case {idx}: {c}"
    elif c["kind"] == 1:
        ez = ksw2.extd2(qseq, tseq, mat, c["q"], c["e"], c["q2"], c["e2"],
                        c["w"], c["zdrop"], c["end_bonus"], c["flag"])
        assert _fmt(ez) == c["golden"], f"case {idx}: {c}"
    else:
        score, qe, te = ksw2.sw_ll(qseq, tseq, mat, c["q"], c["e"])
        assert f"{score} {qe} {te}" == c["golden"], f"case {idx}: {c}"


SPLICE_CASES = json.load(open(golden_path("ksw2_splice_cases.json")))


@pytest.mark.parametrize("idx", range(len(SPLICE_CASES)))
def test_ksw2_splice_case(idx):
    from mm2_gb_tpu.ops.ksw2_splice import exts2
    c = SPLICE_CASES[idx]
    qseq = np.frombuffer(c["qseq"].encode(), np.uint8) - ord("0")
    tseq = np.frombuffer(c["tseq"].encode(), np.uint8) - ord("0")
    mat = ksw2.gen_simple_mat(5, c["a"], c["b"], c["sc_ambi"])
    junc = np.zeros(len(tseq), np.uint8)
    ez = exts2(qseq, tseq, mat, c["q"], c["e"], c["q2"], c["e2"],
               c["zdrop"], c["w"], c["flag"], junc)
    assert _fmt(ez) == c["golden"], f"case {idx}: {c}"
