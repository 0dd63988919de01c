"""End-to-end byte-match tests against golden reference PAFs.

The golden files were generated with the reference minimap2 v2.24
(`-t 1 --max-chain-skip=2147483647`), the byte-compatibility contract this
build inherits from mm2-gb (reference README "Accuracy evaluation").
"""

import io
import os
import sys

import pytest

from mm2_gb_tpu.cli import main
from tests.conftest import golden_path

PAIRS = [
    ("MT-human.fa", "MT-orang.fa", "MT.skipinf.paf"),
    ("t-inv.fa", "q-inv.fa", "t-inv.skipinf.paf"),
    ("t2.fa", "q2.fa", "t2.skipinf.paf"),
]


@pytest.mark.parametrize("target,query,golden", PAIRS)
def test_paf_byte_match(ref_test_dir, target, query, golden, capsys):
    rc = main(["--max-chain-skip=2147483647",
               os.path.join(ref_test_dir, target),
               os.path.join(ref_test_dir, query)])
    assert rc == 0
    out = capsys.readouterr().out
    with open(golden_path(golden)) as f:
        expected = f.read()
    assert out == expected


CIGAR_PAIRS = [
    ("MT-human.fa", "MT-orang.fa", "MT.skipinf.c.paf"),
    ("t-inv.fa", "q-inv.fa", "t-inv.skipinf.c.paf"),
    ("t2.fa", "q2.fa", "t2.skipinf.c.paf"),
]


@pytest.mark.parametrize("target,query,golden", CIGAR_PAIRS)
def test_cigar_paf_byte_match(ref_test_dir, target, query, golden, capsys):
    rc = main(["--max-chain-skip=2147483647", "-c",
               os.path.join(ref_test_dir, target),
               os.path.join(ref_test_dir, query)])
    assert rc == 0
    out = capsys.readouterr().out
    with open(golden_path(golden)) as f:
        assert out == f.read()


def test_sam_byte_match(ref_test_dir, capsys):
    """SAM records match the reference; @PG CL: differs only because the
    golden was generated with the reference binary's own argv (the live
    full-byte check incl. @PG is test_sam_full_byte_match_vs_binary)."""
    rc = main(["--max-chain-skip=2147483647", "-a",
               os.path.join(ref_test_dir, "t-inv.fa"),
               os.path.join(ref_test_dir, "q-inv.fa")])
    assert rc == 0
    got = [l for l in capsys.readouterr().out.splitlines()
           if not l.startswith("@PG")]
    with open(golden_path("t-inv.skipinf.sam")) as f:
        want = [l for l in f.read().splitlines() if not l.startswith("@PG")]
    assert got == want


REF_BIN = "/tmp/refbuild/minimap2_cpu"


@pytest.mark.skipif(not os.path.exists(REF_BIN),
                    reason="reference binary not built")
def test_sam_full_byte_match_vs_binary(ref_test_dir, capsys):
    """FULL SAM — header @PG line included — equals the reference binary
    byte for byte when both are invoked with the identical argv (the @PG
    VN: default is the reference's MM_VERSION, main.c:15/format.c:128)."""
    import subprocess
    args = ["-a", "-t", "1", "--max-chain-skip=2147483647",
            os.path.join(ref_test_dir, "MT-human.fa"),
            os.path.join(ref_test_dir, "MT-orang.fa")]
    ref = subprocess.run([REF_BIN, *args], capture_output=True, text=True)
    assert ref.returncode == 0
    rc = main(args)
    assert rc == 0
    assert capsys.readouterr().out == ref.stdout


MODE_CASES = [
    (["--cs", "-c"], "MT.skipinf.cs.paf"),
    (["-c", "--eqx"], "MT.skipinf.eqx.paf"),
]


@pytest.mark.parametrize("flags,golden", MODE_CASES)
def test_output_modes_byte_match(ref_test_dir, flags, golden, capsys):
    rc = main(["--max-chain-skip=2147483647", *flags,
               os.path.join(ref_test_dir, "MT-human.fa"),
               os.path.join(ref_test_dir, "MT-orang.fa")])
    assert rc == 0
    with open(golden_path(golden)) as f:
        assert capsys.readouterr().out == f.read()


def test_md_sam_byte_match(ref_test_dir, capsys):
    rc = main(["--max-chain-skip=2147483647", "--MD", "-a",
               os.path.join(ref_test_dir, "MT-human.fa"),
               os.path.join(ref_test_dir, "MT-orang.fa")])
    assert rc == 0
    got = [l for l in capsys.readouterr().out.splitlines()
           if not l.startswith("@PG")]
    with open(golden_path("MT.skipinf.MD.sam")) as f:
        want = [l for l in f.read().splitlines() if not l.startswith("@PG")]
    assert got == want


SIM_CASES = [
    ([], "sim200.skipinf.paf.gz"),
    (["--cs", "-c"], "sim200.skipinf.cs.paf.gz"),
]


@pytest.mark.parametrize("flags,golden", SIM_CASES)
def test_sim200_byte_match(flags, golden, capsys):
    """200 simulated ONT-like reads (0.5-20 kb, subs+indels) vs goldens
    from the reference binary at -t 1 --max-chain-skip=2147483647."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", *flags,
               golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path(golden), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_splice_byte_match(capsys):
    """40 synthetic cDNA reads (2-6 exons, GT..AG introns, both strands)
    with -x splice vs the reference binary's output."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "splice", "-c",
               golden_path("splice_genome.fa.gz"),
               golden_path("splice_reads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("splice40.skipinf.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_pe_sr_paf_byte_match(capsys):
    """300 FR read pairs with -x sr (frag mode, heap seed collection,
    select_sub_multi, seg_gen) vs the reference binary."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "sr",
               golden_path("simref.fa.gz"), golden_path("pe_1.fq.gz"),
               golden_path("pe_2.fq.gz")])
    assert rc == 0
    with gzip.open(golden_path("pe300.sr.skipinf.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_pe_sr_sam_byte_match(capsys):
    """Same pairs with -a: exercises mm_pair, mate fields and PE MAPQ."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "sr", "-a",
               golden_path("simref.fa.gz"), golden_path("pe_1.fq.gz"),
               golden_path("pe_2.fq.gz")])
    assert rc == 0
    got = [l for l in capsys.readouterr().out.splitlines()
           if not l.startswith("@PG")]
    with gzip.open(golden_path("pe300.sr.skipinf.sam.gz"), "rt") as f:
        want = [l for l in f.read().splitlines() if not l.startswith("@PG")]
    assert got == want


def test_tpu_chain_pe_falls_back_to_host(capsys):
    """--gpu-chain with multi-segment input must not silently skip PE
    pairing: the reference GPU path is single-segment only
    (assert plchain.cu:499), so we warn and chain on the host."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "sr", "-a",
               "--gpu-chain",
               golden_path("simref.fa.gz"), golden_path("pe_1.fq.gz"),
               golden_path("pe_2.fq.gz")])
    assert rc == 0
    cap = capsys.readouterr()
    assert "falling back to host chaining" in cap.err
    got = [l for l in cap.out.splitlines() if not l.startswith("@PG")]
    with gzip.open(golden_path("pe300.sr.skipinf.sam.gz"), "rt") as f:
        want = [l for l in f.read().splitlines() if not l.startswith("@PG")]
    assert got == want


def test_pe_sr_sam_no_qual_byte_match(capsys):
    """-Q drops the QUAL column like the reference's reader-side strip
    (map.c:1275: with_qual is false under MM_F_NO_QUAL)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "sr", "-a", "-Q",
               golden_path("simref.fa.gz"), golden_path("pe_1.fq.gz"),
               golden_path("pe_2.fq.gz")])
    assert rc == 0
    got = [l for l in capsys.readouterr().out.splitlines()
           if not l.startswith("@PG")]
    with gzip.open(golden_path("pe300.sr.noqual.sam.gz"), "rt") as f:
        want = [l for l in f.read().splitlines() if not l.startswith("@PG")]
    assert got == want


def test_ava_ont_byte_match(capsys):
    """All-vs-all overlap mode (-x ava-ont: NO_DIAG/NO_DUAL/ALL_CHAINS)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "ava-ont",
               golden_path("simreads.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("ava.skipinf.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_split_index_merge(capsys, tmp_path):
    """Multi-part index (-I) + split merge re-ranking across parts."""
    import gzip
    gold = None
    with gzip.open(golden_path("sim200.split120k.c.paf.gz"), "rt") as f:
        gold = f.read()
    rc = main(["--max-chain-skip=2147483647", "-c", "-I", "120k",
               "--split-prefix", str(tmp_path / "sp"),
               golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 0
    assert capsys.readouterr().out == gold


PRESET_CASES = ["map-pb", "map-hifi", "asm5", "asm10", "asm20", "ava-pb"]


@pytest.mark.parametrize("preset", PRESET_CASES)
def test_preset_byte_match(preset, capsys):
    """Every preset family (HPC sketching, asm scoring, ava overlap) vs
    reference goldens on the 200-read simulated set."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", preset, "-c",
               golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path(f"sim200.{preset}.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_junc_bed_byte_match(capsys, tmp_path):
    """--junc-bed: BED12 intron bonuses through the splice DP."""
    import gzip
    bed = tmp_path / "j.bed"
    with gzip.open(golden_path("splice.bed.gz"), "rt") as f:
        bed.write_text(f.read())
    rc = main(["--max-chain-skip=2147483647", "-x", "splice",
               "--junc-bed", str(bed), "-c",
               golden_path("splice_genome.fa.gz"),
               golden_path("splice_reads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("splice40.juncbed.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_alt_contigs_byte_match(capsys):
    """--alt: ALT-aware scoring in parent selection and MAPQ."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "--alt",
               golden_path("alt.txt"), "-c",
               golden_path("altref.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("alt200.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_inversion_alignment_byte_match(capsys):
    """mm_align1_inv path (align.c:828-883) incl. the negative q_off case:
    ksw_ll_i16's qe lands on a striped padding lane, so the C code calls
    mm_align_pair with qseq - 1 (pointer arithmetic into the full query
    buffer).  Golden from reference v2.24 on a 15kb slice of fuzz seed
    1021 (read q4, planted 2.9kb inversion)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-c",
               golden_path("invq4.ref.fa.gz"), golden_path("invq4.q.fa.gz")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "\ttp:A:I\t" in out
    with gzip.open(golden_path("invq4.skipinf.c.paf.gz"), "rt") as f:
        assert out == f.read()


FLAG_CASES = [
    (["-c", "--cs=long"], "sim200.cs-long.paf.gz"),
    # --qstrand: minus-strand hits keep query coords and flip target coords
    # (map.c:319-323); target fetch via mm_idx_getseq_rev (index.c:165-177)
    (["--qstrand", "-c"], "sim200.qstrand.c.paf.gz"),
    (["--rmq", "-c"], "sim200.rmq.paf.gz"),
    (["-k", "13", "-w", "7", "-c"], "sim200.k13w7.paf.gz"),
    (["--for-only", "-c"], "sim200.for-only.paf.gz"),
    # round-1 flag-surface completion: options that alter output
    (["--max-qlen", "9000", "-c"], "sim200.max-qlen9k.c.paf.gz"),
    (["--end-bonus", "12", "-c"], "sim200.end-bonus12.c.paf.gz"),
    (["--chain-skip-scale", "0.5", "-c"], "sim200.chain-skip-scale.c.paf.gz"),
    # -G goes through mm_mapopt_max_intron_len (options.c:84-88): in splice
    # mode it sets bw/bw_long too, not just max_gap_ref
    (["-x", "splice", "-G", "8000", "-c"], "sim200.splice-G8k.c.paf.gz"),
]


@pytest.mark.parametrize("flags,golden", FLAG_CASES)
def test_flag_combo_byte_match(flags, golden, capsys):
    """Distinctive flag combinations (long cs, RMQ chaining, non-default
    k/w, strand restriction) vs reference goldens."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", *flags,
               golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path(golden), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_print_seeds_dump_byte_match(capsys):
    """--print-seeds/--print-chains RS/SD/CN stderr dumps byte-match the
    reference (map.c:383-388, 600-604); QM allocator lines excluded."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "--print-seeds",
               golden_path("invq4.ref.fa.gz"), golden_path("invq4.q.fa.gz")])
    assert rc == 0
    err = [l for l in capsys.readouterr().err.splitlines()
           if l[:3] in ("RS\t", "SD\t", "CN\t")]
    with gzip.open(golden_path("invq4.print-seeds.txt.gz"), "rt") as f:
        want = f.read().splitlines()
    assert err == want


def test_multifile_nonfrag_sequential(capsys):
    """Without frag mode, multiple query files map sequentially per file
    (main.c:451-455) — never interleaved into fragments."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", golden_path("simref.fa.gz"),
               golden_path("pe_1.fq.gz"), golden_path("pe_2.fq.gz")])
    assert rc == 0
    with gzip.open(golden_path("pe300.multifile.nonfrag.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_multifile_frag_interleave(capsys):
    """--frag=yes interleaves files round-robin with linear qname grouping
    (mm_bseq_read_frag2 bseq.c:131-159 + map.c:1299-1304)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "--frag=yes",
               golden_path("simref.fa.gz"),
               golden_path("pe_1.fq.gz"), golden_path("pe_2.fq.gz")])
    assert rc == 0
    with gzip.open(golden_path("pe300.multifile.frag.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_sr_secondary_yes(capsys):
    """--secondary=yes clears the sr preset's MM_F_NO_PRINT_2ND
    (yes_or_no with yes_to_set=0, main.c:252)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "sr",
               "--secondary=yes", golden_path("simref.fa.gz"),
               golden_path("pe_1.fq.gz"), golden_path("pe_2.fq.gz")])
    assert rc == 0
    with gzip.open(golden_path("pe300.sr.secyes.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_sr_pe_split_merge_frag_gap(capsys, tmp_path):
    """-x sr -a with a multi-part index: mm_pair in the merge pass must
    use the map-time frag_gap incl. the max_frag_len branch
    (map.c:509-513, dumped at 1346, consumed at 1264)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "sr", "-a",
               "-I", "120k", "--split-prefix", str(tmp_path / "sp"),
               golden_path("simref.fa.gz"),
               golden_path("pe_1.fq.gz"), golden_path("pe_2.fq.gz")])
    assert rc == 0
    got = [l for l in capsys.readouterr().out.splitlines()
           if not l.startswith("@PG")]
    with gzip.open(golden_path("pe300.sr.split120k.sam.gz"), "rt") as f:
        want = [l for l in f.read().splitlines() if not l.startswith("@PG")]
    assert got == want


def test_junc_bed_gz_byte_match(capsys):
    """--junc-bed accepts gzipped BED directly (gzopen, index.c:670)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "splice",
               "--junc-bed", golden_path("splice.bed.gz"), "-c",
               golden_path("splice_genome.fa.gz"),
               golden_path("splice_reads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("splice40.juncbed.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_multipart_no_split_prefix(capsys):
    """-I without --split-prefix: queries map against each index part
    independently, printed per part with NO merge (main.c:404-462)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-c", "-I", "20k",
               golden_path("multi3.fa.gz"), golden_path("multi3_q.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("multi3.noI.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_multipart_no_split_prefix_sam(capsys):
    """SAM on a true multi-part index without --split-prefix: header has
    no @SQ lines (mm_write_sam_hdr(0,...), main.c:418-421)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-a", "-I", "20k",
               golden_path("multi3.fa.gz"), golden_path("multi3_q.fa.gz")])
    assert rc == 0
    got = [l for l in capsys.readouterr().out.splitlines()
           if not l.startswith("@PG")]
    with gzip.open(golden_path("multi3.noI.sam.gz"), "rt") as f:
        want = [l for l in f.read().splitlines() if not l.startswith("@PG")]
    assert got == want


def test_multipart_true_split_merge(capsys, tmp_path):
    """Two real index parts with --split-prefix: cross-part merge
    re-ranking (merge_hits, map.c:1205-1268)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-c", "-I", "20k",
               "--split-prefix", str(tmp_path / "sp"),
               golden_path("multi3.fa.gz"), golden_path("multi3_q.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("multi3.split.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_tpu_chain_max_occ_rechain(capsys):
    """-f frac,max-occ with --gpu-chain: reads whose seeds all exceed
    mid_occ re-seed at max_occ and re-chain on the host after device
    scoring (CPU-reference semantics, map.c:708-731; the GPU path's own
    branch re-seeds from a freed mv — not reproduced)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-f", "0.0002,50", "-c",
               "--gpu-chain",
               golden_path("rep60.fa.gz"), golden_path("rep60_q.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("rep60.maxocc.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_splice_tpu_chain_align_byte_match(capsys):
    """Splice preset through the device path: is_cdna device chaining
    + host alignment equal the golden (generated from the reference
    binary)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-x", "splice",
               "--junc-bed", golden_path("splice.bed.gz"), "-c",
               "--gpu-chain",
               golden_path("splice_genome.fa.gz"),
               golden_path("splice_reads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("splice40.juncbed.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_multipart_tpu_chain_byte_match(capsys):
    """-I with --gpu-chain: each part maps through the device pipeline;
    outputs equal the host/reference goldens (no-merge and merge)."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-c", "-I", "20k",
               "--gpu-chain",
               golden_path("multi3.fa.gz"), golden_path("multi3_q.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("multi3.noI.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def test_multipart_tpu_chain_split_merge(capsys, tmp_path):
    import gzip
    rc = main(["--max-chain-skip=2147483647", "-c", "-I", "20k",
               "--gpu-chain", "--split-prefix", str(tmp_path / "sp"),
               golden_path("multi3.fa.gz"), golden_path("multi3_q.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("multi3.split.c.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()


def _gz_golden(name):
    import gzip
    with gzip.open(golden_path(name), "rt") as f:
        return f.read()


@pytest.mark.parametrize("golden,flags", [
    ("splitq.I100k.c.paf.gz", ["-I", "100k", "-c"]),
    ("splitq.sponly.paf.gz", []),
    ("splitq.I100k.sam.gz", ["-I", "100k", "-a"]),
])
def test_split_prefix_multifile_truncation_quirk(golden, flags, capsys,
                                                 tmp_path):
    """--split-prefix with >=2 non-frag query files: each mm_map_file
    call re-opens the part tmp with "wb" (map.c:1423, splitidx.c:14-15),
    so only the LAST file's dumps survive; the merge then re-reads the
    queries INTERLEAVED (map.c:1448-1449) and silently keeps stale
    counts with calloc-zeroed regs past dump EOF (misc.c:155-163).  The
    byte contract inherits all of it — including the "-nan" de:f tags
    and the --split-prefix-without--I routing."""
    gold = _gz_golden(golden)
    rc = main(["--max-chain-skip=2147483647", *flags,
               "--split-prefix", str(tmp_path / "sp"),
               golden_path("splitq_ref.fa.gz"), golden_path("splitq_q1.fa.gz"),
               golden_path("splitq_q2.fa.gz")])
    assert rc == 0
    out = capsys.readouterr().out
    out = "\n".join(l for l in out.splitlines()
                    if not l.startswith("@PG"))
    if out and not out.endswith("\n"):
        out += "\n"
    assert out == gold


def test_split_prefix_merge_rl_zero(capsys, tmp_path):
    """Merged split-prefix output prints rl:i:0 for every read: the merge
    pipeline callocs s->rep_len and never fills it (map.c:1300); the
    dumped rep_len max feeds only mm_set_mapq.  Repeat-rich workload so
    the non-split rl would be nonzero (fuzz seed 95110 regression)."""
    gold = _gz_golden("repsplit.sp.c.paf.gz")
    assert "rl:i:" in gold and "rl:i:0" in gold
    rc = main(["--max-chain-skip=2147483647", "-c",
               "--split-prefix", str(tmp_path / "sp"),
               golden_path("repsplit_ref.fa.gz"),
               golden_path("repsplit_q.fa.gz")])
    assert rc == 0
    assert capsys.readouterr().out == gold


def test_gpu_chain_alias(capsys):
    """The --tpu-chain spelling of earlier releases is a hidden alias of
    --gpu-chain: the device path (interpret mode here) reproduces the
    200-read golden byte for byte."""
    import gzip
    rc = main(["--max-chain-skip=2147483647", "--tpu-chain",
               golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("sim200.skipinf.paf.gz"), "rt") as f:
        assert capsys.readouterr().out == f.read()
