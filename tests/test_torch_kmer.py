"""The port's k-mer tools and pipeline executor against the reference's, on
the CPU.

- tests/test_pipeline_kmer.py, test by test, through the port's modules
  (``janusx_tpu_torch.models.kmer``, ``cli.kmer``, ``pipeline``,
  ``utils.interrupt``), each count also equal to the reference's where the
  reference test counts; its ``test_bench_two_point_fit`` times the JAX
  package's bench.py, which the port does not carry.
- ``jx kmer``, ``jx kmerge`` and ``jx kstats`` through both dispatchers:
  every output byte-identical (an ``.npz`` member by member, since its
  zip entries carry the time they were written).
- the k-mer GWAS slice at small size: 60 haploid FASTA genomes of 20 kb
  with 200 biallelic sites -> ``jx kmer -k 31 -stream-db`` -> ``jx kmerge
  -freq 0.05`` -> ``jx gwas -lmm -force-model``, the reference with JAX on
  the CPU, held to tests/test_torch_gwas_cli.py's ``-lmm`` bounds (the same
  rows, max Δ(-log10 p) <= 0.05, the same top 5, λ_null within 2e-3); the
  k-mers of one site carry one test (the ref and the alt k-mers have
  complementary presence), so the top 5 are counted in tests, as
  chip_smoke.py's phase 17 counts them, whose simulation and host checks
  this runs at small size.

Both packages build and share native/libjxkmer.so; the module takes a
file lock beside native/ around the first load, so that two test files
in two workers never build it at once.
"""

import fcntl
import io
import json
import os
import re
import zipfile
from collections import Counter
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from janusx_tpu.cli.main import main as j_jx
from janusx_tpu.models import kmer as j_kmer
from janusx_tpu_torch.cli.kmer import kmerge_main, kstats_main
from janusx_tpu_torch.cli.kmer import main as kmer_main
from janusx_tpu_torch.cli.main import main as t_jx
from janusx_tpu_torch.models import kmer
from janusx_tpu_torch.pipeline.executor import Pipeline, Step, check_tool

import chip_smoke as smoke

ROOT = Path(__file__).resolve().parent.parent
NATIVE_LOCK = ROOT / "native.lock"


def load_native_locked(*modules) -> None:
    """Each module's ``_load()`` (which builds its library under native/
    when it is missing or older than its source) under an exclusive lock
    on NATIVE_LOCK."""
    with open(NATIVE_LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        for mod in modules:
            mod._load()


@pytest.fixture(autouse=True, scope="module")
def _native():
    load_native_locked(j_kmer, kmer)
    assert kmer.available() and j_kmer.available(), "g++ build of native/jxkmer.cpp failed"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JX_TPU_PLATFORM", "cpu")
        mp.setenv("JX_TPU_HISTORY_DB", "0")
        yield


def _same_counts(path, **kw):
    """The port's count_kmers, equal to the reference's on the same call."""
    c, n = kmer.count_kmers(str(path), **kw)
    rc, rn = j_kmer.count_kmers(str(path), **kw)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(n, rn)
    return c, n


# ------------------------------------------------ tests/test_pipeline_kmer.py
def test_pipeline_resume_and_skip(tmp_path):
    od = str(tmp_path)
    marker = lambda i, s: os.path.join(od, f"{s}.{i['id']}.out")
    steps = [
        Step("s1", lambda i: f"echo one > {marker(i, 's1')}", lambda i: [marker(i, "s1")]),
        Step("s2", lambda i: f"echo two > {marker(i, 's2')}", lambda i: [marker(i, "s2")]),
    ]
    items = [{"id": "a"}, {"id": "b"}]
    state = os.path.join(od, "state.json")
    p = Pipeline("test", steps, items, state)
    rep = p.run()
    assert rep["ran"] == 4 and rep["failed"] == 0
    assert p.first_incomplete_step() == 2
    rep2 = Pipeline("test", steps, items, state).run()
    assert rep2["ran"] == 0 and rep2["skipped"] == 4
    st = json.load(open(state))
    st["completed"]["s2"].remove("b")
    json.dump(st, open(state, "wt"))
    os.remove(marker({"id": "b"}, "s2"))
    rep3 = Pipeline("test", steps, items, state).run()
    assert rep3["ran"] == 1


def test_pipeline_failure_stops(tmp_path):
    steps = [Step("bad", lambda i: "false", lambda i: []),
             Step("never", lambda i: "echo no", lambda i: [])]
    rep = Pipeline("t", steps, [{"id": "x"}], str(tmp_path / "st.json")).run()
    assert rep["failed"] == 1
    assert len(rep["steps"]) == 1


def test_check_tool():
    assert check_tool("ls")["found"]
    assert not check_tool("definitely_not_a_tool_xyz")["found"]


def test_fastq2vcf_dry_run(tmp_path):
    from janusx_tpu.pipeline.fastq2vcf import build_pipeline as j_build
    from janusx_tpu_torch.pipeline.fastq2vcf import Fastq2VcfConfig, build_pipeline

    kw = dict(ref_fasta="ref.fa", out_dir=str(tmp_path),
              samples=[{"id": "s1", "fq1": "a_1.fq", "fq2": "a_2.fq"}])
    cfg = Fastq2VcfConfig(**kw)
    per_sample, cohort = build_pipeline(cfg)
    per_sample.options.dry_run = True
    cohort.options.dry_run = True
    rep = per_sample.run()
    assert rep["ran"] == 3
    cmd = per_sample.steps[1].command(cfg.samples[0])
    assert "bwa mem" in cmd and "samblaster" in cmd and "samtools sort" in cmd
    # every step's command is the reference's
    from janusx_tpu.pipeline.fastq2vcf import Fastq2VcfConfig as JCfg

    for mine, theirs in zip((per_sample, cohort), j_build(JCfg(**kw))):
        item = cfg.samples[0] if mine is per_sample else mine.items[0]
        assert [s.command(item) for s in mine.steps] == [s.command(item) for s in theirs.steps]


def test_kmer_counter(tmp_path):
    fa = tmp_path / "x.fa"
    fa.write_text(">r1\nACGTACGTAC\n")
    codes, counts = _same_counts(fa, k=4)
    kmers = {kmer.decode_kmer(c, 4): int(n) for c, n in zip(codes, counts)}
    assert sum(kmers.values()) == 7
    assert all(len(s) == 4 for s in kmers)
    fb = tmp_path / "y.fa"
    fb.write_text(">r1\nACGTACGTAC\nTTTTTTTTTT\n")
    ca, _ = kmer.count_kmers(str(fa), k=4)
    cb, _ = kmer.count_kmers(str(fb), k=4)
    codes, mat, samples = kmer.merge_to_matrix({"a": (ca, None), "b": (cb, None)},
                                               min_samples=1, max_samples=2)
    assert mat.shape[1] == 2
    gd = kmer.kmer_matrix_to_genotypes(codes, mat, samples, 4)
    assert gd.m == len(codes)
    rcodes, rmat, _ = j_kmer.merge_to_matrix({"a": (ca, None), "b": (cb, None)},
                                             min_samples=1, max_samples=2)
    np.testing.assert_array_equal(codes, rcodes)
    np.testing.assert_array_equal(mat, rmat)


def test_kmer_revcomp_invariance(tmp_path):
    fa = tmp_path / "f.fa"
    fa.write_text(">r\nACGGTTCAGGCAT\n")
    fb = tmp_path / "r.fa"
    fb.write_text(">r\nATGCCTGAACCGT\n")
    ca, na = _same_counts(fa, k=5)
    cb, nb = kmer.count_kmers(str(fb), k=5)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(na, nb)


def test_graceful_interrupts_scope():
    import signal

    from janusx_tpu_torch.utils.interrupt import graceful_interrupts, interrupted

    with graceful_interrupts():
        assert not interrupted()
        signal.raise_signal(signal.SIGINT)
        assert interrupted()
    assert not interrupted()


def test_kmer_multiline_fasta_spanning(tmp_path):
    seq, k = "ACGTACGTACGTACGT", 8
    p1 = tmp_path / "a.fa"
    p1.write_text(">s\n" + seq + "\n")
    p2 = tmp_path / "b.fa"
    p2.write_text(">s\n" + "\n".join(seq[i:i + 5] for i in range(0, len(seq), 5)) + "\n")
    c1, n1 = _same_counts(p1, k=k)
    c2, n2 = _same_counts(p2, k=k)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(n1, n2)
    assert int(n1.sum()) == len(seq) - k + 1


def _reads(path, n_reads, readlen, seed):
    rng = np.random.default_rng(seed)
    reads = ["".join("ACGT"[b] for b in rng.integers(0, 4, readlen)) for _ in range(n_reads)]
    path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * readlen}\n" for i, s in enumerate(reads)))


def test_kmer_streaming_chunks_match_oneshot(tmp_path):
    fq = tmp_path / "r.fastq"
    _reads(fq, 400, 80, seed=5)
    c_big, n_big = _same_counts(fq, k=15)
    c_small, n_small = _same_counts(fq, k=15, chunk_bytes=1 << 12)
    np.testing.assert_array_equal(c_big, c_small)
    np.testing.assert_array_equal(n_big, n_small)
    assert int(n_big.sum()) == 400 * 66


def test_kmer_threaded_matches_python_reference(tmp_path):
    rng = np.random.default_rng(6)
    k = 9
    seqs = ["".join("ACGT"[b] for b in rng.integers(0, 4, 120)) for _ in range(60)]
    fa = tmp_path / "g.fa"
    fa.write_text("".join(f">c{i}\n{s}\n" for i, s in enumerate(seqs)))

    def canon(s):
        return min(s, s[::-1].translate(str.maketrans("ACGT", "TGCA")))

    ref = Counter(canon(s[i:i + k]) for s in seqs for i in range(len(s) - k + 1))
    codes, counts = _same_counts(fa, k=k, threads=8)
    assert {kmer.decode_kmer(c, k): int(n) for c, n in zip(codes, counts)} == dict(ref)


def test_kmer_giant_fasta_record_streaming(tmp_path):
    rng = np.random.default_rng(8)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 40_000))
    fa = tmp_path / "giant.fa"
    fa.write_text(">chr1\n" + "\n".join(seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    k = 13
    c1, n1 = _same_counts(fa, k=k)
    c2, n2 = _same_counts(fa, k=k, chunk_bytes=4096)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(n1, n2)
    assert int(n1.sum()) == len(seq) - k + 1


def _npz_sets(tmp_path, sets, counts=None):
    paths = []
    for sid, codes in sets.items():
        p = tmp_path / f"x.{sid}.k21.npz"
        c = np.ones(len(codes), np.int64) if counts is None else np.array(counts[sid], np.uint32)
        np.savez_compressed(p, codes=np.array(codes, np.uint64), counts=c, k=21)
        paths.append(str(p))
    return paths


def test_kstats_pair_venn(tmp_path):
    paths = _npz_sets(tmp_path, {"A": [1, 2, 3, 4, 5, 10], "B": [3, 4, 5, 6, 7],
                                 "C": [5, 10, 20]})
    assert kstats_main(["-i", *paths, "-pair", "both", "-venn", "-o", str(tmp_path),
                        "-prefix", "ks"]) == 0
    inter = [ln.split("\t") for ln in
             open(tmp_path / "ks.pair.intersection.tsv").read().splitlines()]
    assert inter[2][0] == "B" and inter[2][1] == "3"
    assert inter[3][1] == "2" and inter[3][2] == "1"
    venn = {ln.split("\t")[0]: int(ln.split("\t")[-1]) for ln in
            open(tmp_path / "ks.venn.tsv").read().splitlines()[1:]}
    assert venn["110"] == 2 and venn["111"] == 1 and venn["001"] == 1


def test_kmer_spill_matches_inram(tmp_path):
    fq = tmp_path / "x.fastq"
    _reads(fq, 400, 80, seed=3)
    ref_c, ref_n = _same_counts(fq, k=17, min_count=1)
    spill_c, spill_n = kmer.count_kmers(str(fq), k=17, min_count=1, mem_budget_bytes=64 << 10,
                                        spill_dir=str(tmp_path / "spill"))
    np.testing.assert_array_equal(spill_c, ref_c)
    np.testing.assert_array_equal(spill_n, ref_n)
    assert not list((tmp_path / "spill").glob("jxkmer_part*"))
    ref2 = kmer.count_kmers(str(fq), k=17, min_count=2)
    sp2 = kmer.count_kmers(str(fq), k=17, min_count=2, mem_budget_bytes=64 << 10,
                           spill_dir=str(tmp_path / "spill2"))
    np.testing.assert_array_equal(sp2[0], ref2[0])
    np.testing.assert_array_equal(sp2[1], ref2[1])


def test_kmer_budget_fails_fast_without_spill(tmp_path):
    rng = np.random.default_rng(5)
    fa = tmp_path / "big.fa"
    fa.write_text(">chr\n" + "".join("ACGT"[b] for b in rng.integers(0, 4, 200_000)) + "\n")
    with pytest.raises(MemoryError, match="memory budget"):
        kmer.count_kmers(str(fa), k=21, mem_budget_bytes=64 << 10, spill_dir="")


def test_kmer_wide_keys_k_up_to_64(tmp_path):
    rng = np.random.default_rng(11)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 1500))
    fa = tmp_path / "w.fa"
    fa.write_text(f">c\n{seq}\n")
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}

    def pyref(k):
        return dict(Counter(min(seq[i:i + k], "".join(comp[x] for x in reversed(seq[i:i + k])))
                            for i in range(len(seq) - k + 1)))

    for k in (33, 64):
        codes, counts = _same_counts(fa, k=k, min_count=1)
        assert codes.dtype == kmer.WIDE_DTYPE
        assert {kmer.decode_kmer(c, k): int(n) for c, n in zip(codes, counts)} == pyref(k)
        sp_c, sp_n = kmer.count_kmers(str(fa), k=k, min_count=1, mem_budget_bytes=64 << 10)
        np.testing.assert_array_equal(sp_c, codes)
        np.testing.assert_array_equal(sp_n, counts)
    per = {"a": kmer.count_kmers(str(fa), k=40), "b": kmer.count_kmers(str(fa), k=40)}
    codes, mat, samples = kmer.merge_to_matrix(per, min_samples=2, max_samples=2)
    assert len(codes) and mat.shape == (len(codes), 2)
    gd = kmer.kmer_matrix_to_genotypes(codes[:3], mat[:3], samples, 40)
    assert all(len(s) == 40 for s in gd.sites.snp)
    with pytest.raises(RuntimeError, match="bad k"):
        kmer.count_kmers(str(fa), k=65)


def test_kmer_cli_reference_flags_and_tree(tmp_path):
    rng = np.random.default_rng(3)
    base = "".join(rng.choice(list("ACGT"), 400))
    mut = list(base)
    for i in range(0, 400, 9):
        mut[i] = "ACGT"[("ACGT".index(mut[i]) + 1) % 4]
    far = "".join(rng.choice(list("ACGT"), 400))
    for name, seq in (("s1", base), ("s2", base), ("s3", "".join(mut)), ("s4", far)):
        (tmp_path / f"{name}.fa").write_text(f">r\n{seq}\n")
    fas = [str(tmp_path / f"s{i}.fa") for i in range(1, 5)]
    assert kmer_main(["-fa", *fas, "--kmer-len", "15", "-ci", "1", "-cx", "1000000", "-m", "1",
                      "--tmp-dir", str(tmp_path / "spill"), "-tree", "-o", str(tmp_path),
                      "-p", "km"]) == 0
    for s in ("s1", "s2", "s3", "s4"):
        assert (tmp_path / f"km.{s}.k15.npz").exists()
    nwk = (tmp_path / "km.kmer.nwk").read_text().strip()
    assert nwk.endswith(";") and all(s in nwk for s in ("s1", "s2", "s3", "s4"))
    assert re.search(r"\((s1|s2):[^,]*,(s1|s2):", nwk), nwk
    assert kmer_main(["-i", fas[0], "-k", "15", "-ci", "1", "-cx", "1", "-o", str(tmp_path),
                      "-p", "kx"]) == 0
    d_all = np.load(tmp_path / "km.s1.k15.npz")
    d_cx = np.load(tmp_path / "kx.s1.k15.npz")
    assert (d_cx["counts"] <= 1).all()
    assert len(d_cx["codes"]) <= len(d_all["codes"])


def test_kstats_kbin_compare_and_min_count(tmp_path):
    sets = {"A": [1, 2, 3, 10], "B": [2, 3, 7], "C": [3, 10, 20]}
    paths = _npz_sets(tmp_path, sets, counts={"A": [5, 1, 3, 2], "B": [2, 2, 9],
                                              "C": [1, 4, 4]})
    assert kmerge_main(["-db", *paths, "-min-samples", "1", "-o", str(tmp_path),
                        "-prefix", "km"]) == 0
    assert kstats_main(["-kbin", str(tmp_path / "km"), "-compare", "AB=A,B", "C",
                        "-o", str(tmp_path), "-prefix", "kb"]) == 0
    rows = [ln.split("\t") for ln in open(tmp_path / "kb.compare.tsv").read().splitlines()]
    assert rows[0] == ["group_a", "group_b", "only_a", "only_b", "shared", "jaccard"]
    ga, gb, only_a, only_b, shared, _ = rows[1]
    assert (ga, gb) == ("AB", "group2")
    assert (int(only_a), int(only_b), int(shared)) == (3, 1, 1)
    assert kstats_main(["-db", *paths, "--min-count", "3", "-pair", "intersection", "-venn",
                        "-o", str(tmp_path), "-prefix", "mc"]) == 0
    inter = [ln.split("\t") for ln in
             open(tmp_path / "mc.pair.intersection.tsv").read().splitlines()]
    assert inter[2][1] == "0" and inter[3][1] == "0" and inter[3][2] == "0"


def test_kmer_sorted_phase2_matches_hash(tmp_path, monkeypatch):
    fq = tmp_path / "r.fastq"
    _reads(fq, 4000, 100, seed=3)
    for kwargs in ({}, {"chunk_bytes": 1 << 17}, {"min_count": 2}):
        monkeypatch.setenv("JX_KMER_PHASE2", "hash")
        c1, n1 = _same_counts(fq, k=21, **kwargs)
        monkeypatch.setenv("JX_KMER_PHASE2", "sort")
        c2, n2 = _same_counts(fq, k=21, **kwargs)
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(n1, n2)
        if kwargs.get("min_count", 1) == 1:
            assert len(c1) > 0
            assert np.all(np.diff(c2.astype(np.int64)) > 0)


def test_kmer_stream_db_matches_count(tmp_path):
    fq = tmp_path / "r.fastq"
    _reads(fq, 4000, 100, seed=5)
    c, n = kmer.count_kmers(str(fq), k=21)
    w = kmer.stream_kmer_count(str(fq), str(tmp_path / "a.jxkdb"), k=21)
    j_kmer.stream_kmer_count(str(fq), str(tmp_path / "ra.jxkdb"), k=21)
    assert (tmp_path / "a.jxkdb").read_bytes() == (tmp_path / "ra.jxkdb").read_bytes()
    cs, ns, kk = kmer.load_kmer_db(str(tmp_path / "a.jxkdb"))
    assert w == len(c) and kk == 21
    np.testing.assert_array_equal(np.asarray(cs), c)
    np.testing.assert_array_equal(np.asarray(ns), n)
    kmer.stream_kmer_count(str(fq), str(tmp_path / "b.jxkdb"), k=21, mem_budget_bytes=1 << 20)
    cs2, ns2, _ = kmer.load_kmer_db(str(tmp_path / "b.jxkdb"))
    np.testing.assert_array_equal(np.asarray(cs2), c)
    np.testing.assert_array_equal(np.asarray(ns2), n)
    c3, n3 = kmer.count_kmers(str(fq), k=33)
    kmer.stream_kmer_count(str(fq), str(tmp_path / "c.jxkdb"), k=33)
    cs3, ns3, k3 = kmer.load_kmer_db(str(tmp_path / "c.jxkdb"))
    assert k3 == 33 and cs3.dtype == c3.dtype == kmer.WIDE_DTYPE
    np.testing.assert_array_equal(cs3, c3)
    np.testing.assert_array_equal(np.asarray(ns3), n3)
    assert np.concatenate([cs3, c3]).dtype == kmer.WIDE_DTYPE
    c4, n4 = kmer.count_kmers(str(fq), k=21, min_count=2)
    kmer.stream_kmer_count(str(fq), str(tmp_path / "d.jxkdb"), k=21, min_count=2)
    cs4, ns4, _ = kmer.load_kmer_db(str(tmp_path / "d.jxkdb"))
    np.testing.assert_array_equal(np.asarray(cs4), c4)
    np.testing.assert_array_equal(np.asarray(ns4), n4)


def test_kmer_cli_stream_db_and_kstats(tmp_path):
    fq = tmp_path / "s1.fastq"
    _reads(fq, 500, 100, seed=7)
    assert kmer_main(["-i", str(fq), "-k", "15", "-ci", "1", "-stream-db", "-o", str(tmp_path),
                      "-prefix", "kdb"]) == 0
    db = tmp_path / "kdb.s1.k15.jxkdb"
    assert db.exists()
    assert kmer_main(["-i", str(fq), "-k", "15", "-ci", "1", "-o", str(tmp_path),
                      "-prefix", "knpz"]) == 0
    npz = tmp_path / "knpz.s1.k15.npz"
    outs = []
    for path, tag in ((db, "st1"), (npz, "st2")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert kstats_main(["-db", str(path), "-o", str(tmp_path), "-prefix", tag]) == 0
        outs.append([ln.split("\t")[1:] for ln in buf.getvalue().splitlines()])
    assert outs[0] == outs[1] and len(outs[0]) >= 2


def test_jxkdb_malformed_inputs_rejected(tmp_path):
    bad = tmp_path / "bad.jxkdb"
    bad.write_bytes(b"NOTMAGIC" + b"\0" * 8)
    with pytest.raises(ValueError, match="jxkdb"):
        kmer.load_kmer_db(str(bad))
    bad.write_bytes(b"JXKMERDB")
    with pytest.raises(ValueError):
        kmer.load_kmer_db(str(bad))
    bad.write_bytes(b"JXKMERDB" + bytes([9, 21, 0]) + b"\0" * 5)
    with pytest.raises(ValueError):
        kmer.load_kmer_db(str(bad))
    ok = tmp_path / "ok.jxkdb"
    rec = np.zeros(3, dtype=[("code", "<u8"), ("count", "<u4")])
    rec["code"] = [5, 9, 11]
    rec["count"] = [2, 1, 7]
    with open(ok, "wb") as fh:
        fh.write(b"JXKMERDB" + bytes([1, 21, 0]) + b"\0" * 5)
        rec.tofile(fh)
    codes, counts, k = kmer.load_kmer_db(str(ok))
    assert k == 21
    np.testing.assert_array_equal(np.asarray(codes), [5, 9, 11])
    np.testing.assert_array_equal(np.asarray(counts), [2, 1, 7])
    codes2, _, _ = kmer.load_kmer_db(str(ok), mmap=False)
    np.testing.assert_array_equal(np.asarray(codes2), [5, 9, 11])


# ------------------------------------------------ both dispatchers
def _files(d):
    """Each file's bytes; an .npz member by member."""
    out = {}
    for f in sorted(os.listdir(d)):
        p = os.path.join(d, f)
        if f.endswith(".npz"):
            with zipfile.ZipFile(p) as z:
                out[f] = {name: z.read(name) for name in sorted(z.namelist())}
        elif not f.endswith(".log"):
            out[f] = open(p, "rb").read()
    return out


def _both(tmp_path, argv, tag):
    got = {}
    for name, main in (("ref", j_jx), ("port", t_jx)):
        d = tmp_path / f"{tag}_{name}"
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv + ["-o", str(d)]) == 0, name
        got[name] = (_files(d), buf.getvalue().replace(str(d), "OUT"))
    return got["ref"], got["port"]


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    d = tmp_path_factory.mktemp("genomes")
    return smoke.simulate_genomes(str(d), n=8, length=6000, sites=40, seed=12)


@pytest.mark.parametrize("args", [["-k", "21", "-min-count", "1", "-stream-db"],
                                  ["-k", "15", "-tree"], ["-k", "25", "-cx", "1",
                                                          "--counter-max", "1"]],
                         ids=["stream-db", "npz-tree", "cx"])
def test_kmer_cli_matches_reference(genomes, tmp_path, args):
    ref, port = _both(tmp_path, ["kmer", "-i", *genomes[0], *args], "k")
    assert port == ref and len(port[0]) >= len(genomes[0])


@pytest.mark.parametrize("fmt", ["jxkdb", "npz"])
def test_kmerge_kstats_cli_match_reference(genomes, tmp_path, fmt):
    extra = ["-stream-db"] if fmt == "jxkdb" else []
    assert t_jx(["kmer", "-i", *genomes[0], "-k", "21", "-min-count", "1", *extra,
                 "-o", str(tmp_path / "k")]) == 0
    dbs = [str(tmp_path / "k" / f"kmer.g{j}.k21.{fmt}") for j in range(len(genomes[0]))]
    for argv in (["kmerge", "-i", *dbs, "-freq", "0.1"],
                 ["kmerge", "-i", *dbs, "-min-samples", "2", "--min-count", "1"]):
        ref, port = _both(tmp_path, argv, "m")
        assert port == ref
        assert {"kmerged.bed", "kmerged.bim", "kmerged.fam", "kmerged.bin",
                "kmerged.bin.site", "kmerged.bin.id"} <= set(port[0]), sorted(port[0])
    ref, port = _both(tmp_path, ["kstats", "-kbin", str(tmp_path / "m_port" / "kmerged"),
                                 "-compare", "g0,g1,g2", "g3,g4"], "kb")
    assert port == ref and "kstats.compare.tsv" in port[0]
    ref, port = _both(tmp_path, ["kstats", "-i", *dbs, "-pair", "both", "-venn"], "ks")
    assert port == ref and {"kstats.pair.union.tsv", "kstats.venn.tsv"} <= set(port[0])


# ------------------------------------------------ the k-mer GWAS slice
def test_kmer_gwas_slice_matches_reference(tmp_path):
    """60 genomes of 20 kb with 200 sites, through chip_smoke.py phase 17's
    simulation and host checks (k-mer counts against a plain numpy count,
    the presence matrix against the planted genotypes), then ``jx gwas
    -lmm`` on the k-mer panel, port against reference."""
    k, n = smoke.KMER_K, 60
    paths, ref, pos, alt, geno = smoke.simulate_genomes(str(tmp_path), n=n, length=20_000,
                                                        sites=200, seed=21)
    pheno = str(tmp_path / "trait.pheno")
    smoke.write_kmer_trait(pheno, geno, seed=22)
    res = {}
    for name, main in (("ref", j_jx), ("port", t_jx)):
        d = tmp_path / name
        assert main(["kmer", "-i", *paths, "-k", str(k), "-min-count", "1", "-stream-db",
                     "-t", "2", "-o", str(d / "k")]) == 0
        dbs = [str(d / "k" / f"kmer.g{j}.k{k}.jxkdb") for j in range(n)]
        assert main(["kmerge", "-i", *dbs, "-freq", smoke.KMER_FREQ, "-o", str(d / "m")]) == 0
        assert main(["gwas", "-bfile", str(d / "m" / "kmerged"), "-p", pheno, "-lmm",
                     "-force-model", "-o", str(d / "g")]) == 0
        res[name] = d
    # jx kmerge's files (jx gwas then cached its GRM beside them, within
    # rtol 1e-6 of the reference's: tests/test_torch_grm.py)
    ra, pa = ({f: v for f, v in _files(res[s] / "m").items() if ".cGRM." not in f}
              for s in ("ref", "port"))
    assert pa == ra and len(pa) == 6
    assert smoke.check_kmer_counts(str(res["port"] / "k"), ref, pos, alt, geno, k, 3) > 0
    codes, P, site_rows, n_spanning = smoke.check_presence(
        str(res["port"] / "m" / "kmerged"), ref, pos, alt, geno, k)
    in_band = (geno.mean(1) >= 0.05) & (geno.mean(1) <= 0.95)
    assert n_spanning >= 0.9 * 2 * k * in_band.sum()
    got = {}
    for name in res:
        with open(res[name] / "g" / "jx.trait.LMM.assoc.tsv") as fh:
            header = fh.readline()
            rows = [ln.rstrip("\n").split("\t") for ln in fh]
        with open(res[name] / "g" / "jx.gwas.summary.json") as fh:
            lam = json.load(fh)["runs"][0]["lambda_null"]
        got[name] = header, rows, lam
    (h_ref, rows_ref, lam_ref), (h_port, rows_port, lam_port) = got["ref"], got["port"]
    assert h_port == h_ref and len(rows_port) == len(rows_ref) > 3000
    assert [r[:7] for r in rows_port] == [r[:7] for r in rows_ref]
    assert all(r[0] == "K" and r[3:5] == ["absent", "present"] for r in rows_port)
    # max Δ(-log10 p) <= 0.05 and the same top 5, a site's k-mers (the same
    # or the complementary presence) counted as one test
    row_of = smoke.kmer_rows(smoke.kmer_codes([r[2] for r in rows_port], k), codes)
    assert (row_of >= 0).all()
    smoke.agree_groups([float(r[10]) for r in rows_port], [float(r[10]) for r in rows_ref],
                       smoke.pattern_groups(P[row_of]), "port vs reference", 0.05)
    assert lam_port == pytest.approx(lam_ref, rel=2e-3)
