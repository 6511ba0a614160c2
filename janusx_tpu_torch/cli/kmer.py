"""`jx kmer` / `jx kmerge` / `jx kstats` — k-mer pipeline
(reference: src/kmer/ + script/kmer.py, kmerge.py, kstats.py)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from janusx_tpu_torch.cli import common


def build_parser(prog="jx kmer") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="count k-mers per sample")
    p.add_argument("-i", "-fa", "--inputs", "--fa", dest="inputs", type=str,
                   nargs="+", required=True,
                   help="FASTA/FASTQ(.gz) files, one per sample "
                   "(reference spelling: -fa)")
    p.add_argument("-k", "--k", "--kmer-len", dest="k", type=int, default=21)
    p.add_argument("-min-count", "--min-count", "-ci", "--cutoff-min",
                   dest="min_count", type=int, default=2,
                   help="minimal k-mer count cutoff (reference -ci)")
    p.add_argument("-cx", "--cutoff-max", dest="max_count", type=int,
                   default=None,
                   help="maximal k-mer count cutoff (reference -cx)")
    p.add_argument("--counter-max", type=int, default=None,
                   help="cap stored counter values (reference KMC -cs)")
    p.add_argument("-mem", "--mem", "-m", "--max-ram-gb", "-limit-mem",
                   "--limit-mem", dest="mem", type=float, default=None,
                   metavar="GB",
                   help="in-RAM k-mer table budget in GB; tables that "
                   "would cross it spill to on-disk partition buckets "
                   "(KMC-class external-memory counting) and finalize "
                   "one bucket at a time (reference -m/-limit-mem)")
    p.add_argument("-spill-dir", "--spill-dir", "--tmp-dir",
                   dest="spill_dir", type=str, default=None,
                   help="directory for spill buckets (default: temp dir); "
                   "'' disables spilling — the counter then fails fast "
                   "at 2x the -mem budget instead of swapping "
                   "(reference --tmp-dir)")
    p.add_argument("-t", "--threads", dest="threads", type=int, default=None,
                   help="counter threads (default: all cores)")
    # reference hidden mode flags (kmer.py:585-597): -count is the
    # default behavior; -tree builds a presence-based NJ tree of the
    # counted samples on top of it
    p.add_argument("-count", "--count", action="store_true",
                   help=argparse.SUPPRESS)
    # reference hidden WASTER tuning knobs (kmer.py:597-640): the -tree
    # analog here is presence-Jaccard NJ, so the read-sampling parameters
    # have no effect — accepted and warn-logged when explicitly set
    _W = ("the -tree analog here is presence-Jaccard NJ over counted "
          "k-mers; WASTER read-sampling has no stage to tune")
    common.add_compat_flags(p, [
        ("--waster-mode", {"type": int, "choices": (1, 2, 3, 4)}, _W),
        ("--waster-sampled", {"type": int}, _W),
        ("--waster-qcs", {"type": int}, _W),
        ("--waster-qcn", {"type": int}, _W),
        ("--waster-pattern", {"type": int}, _W),
        ("--waster-consensus", {"type": int}, _W),
        ("--waster-continue-file", {"type": str}, _W),
    ])
    p.add_argument("-stream-db", "--stream-db", action="store_true",
                   help="stream the sorted count table to a binary "
                   ".jxkdb file partition-by-partition instead of "
                   "materializing it in RAM (KMC-style streamed output; "
                   "peak memory ~1/256 of the table — use for "
                   "low-duplication inputs whose full table would not "
                   "fit in RAM). kmerge/kstats accept .jxkdb inputs")
    p.add_argument("-tree", "--tree", action="store_true",
                   help="also build an NJ tree of the samples from "
                   "shared-k-mer (Jaccard) distances of the presence "
                   "matrix -> {prefix}.kmer.nwk (needs >= 3 inputs; "
                   "reference hidden -tree mode)")
    common.add_out_args(p, default_prefix="kmer")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "kmer")
    common.warn_ignored_compat(parser, args)

    from janusx_tpu_torch.models import kmer

    if not kmer.available():
        raise SystemExit("native k-mer counter unavailable (needs g++)")
    if args.tree and len(args.inputs) < 3:
        raise SystemExit("-tree needs at least 3 input samples")
    outputs = []
    per_sample = {}
    for path in args.inputs:
        sid = os.path.basename(path).split(".")[0]
        budget = (None if args.mem is None
                  else int(args.mem * (1 << 30)))
        if args.stream_db:
            if args.tree or args.max_count is not None \
                    or args.counter_max is not None:
                raise SystemExit(
                    "-stream-db streams raw sorted counts; it composes "
                    "with -ci but not -tree/-cx/--counter-max")
            out = f"{prefix}.{sid}.k{args.k}.jxkdb"
            n_rec = kmer.stream_kmer_count(
                path, out, k=args.k, min_count=args.min_count,
                threads=args.threads, mem_budget_bytes=budget,
                spill_dir=args.spill_dir,
            )
            outputs.append(out)
            print(f"{sid}\t{n_rec} k-mers\t{out}")
            continue
        codes, counts = kmer.count_kmers(
            path, k=args.k, min_count=args.min_count,
            threads=args.threads,
            mem_budget_bytes=budget,
            spill_dir=args.spill_dir,
        )
        if args.max_count is not None:
            keep = counts <= args.max_count
            codes, counts = codes[keep], counts[keep]
        if args.counter_max is not None:
            counts = np.minimum(counts, args.counter_max)
        out = f"{prefix}.{sid}.k{args.k}.npz"
        np.savez_compressed(out, codes=codes, counts=counts, k=args.k)
        outputs.append(out)
        if args.tree:
            per_sample[sid] = (codes, counts)
        print(f"{sid}\t{len(codes)} k-mers\t{out}")
    if args.tree:
        # presence-based sample phylogeny (functional analog of the
        # reference's hidden read-based WASTER tree mode): Jaccard
        # distance over the shared-k-mer presence matrix, RapidNJ join
        from janusx_tpu_torch.models.tree import rapid_neighbor_joining

        codes_m, mat, samples = kmer.merge_to_matrix(
            per_sample, min_samples=1, max_samples=len(per_sample))
        P = mat.astype(np.float64)  # (m, n) presence
        inter = P.T @ P
        sizes = P.sum(axis=0)
        union = sizes[:, None] + sizes[None, :] - inter
        D = 1.0 - inter / np.maximum(union, 1.0)
        np.fill_diagonal(D, 0.0)
        nwk = rapid_neighbor_joining(D, list(samples))
        tree_path = f"{prefix}.kmer.nwk"
        with open(tree_path, "wt") as fh:
            fh.write(nwk + "\n")
        print(f"tree\t{len(codes_m)} shared k-mers\t{tree_path}")
    return 0


def _sample_id(path: str) -> str:
    """Sample ID from a `jx kmer` output name: strips the .k{K}.npz /
    .k{K}.jxkdb suffix and any leading out-prefix component."""
    import re

    base = os.path.basename(path)
    base = re.sub(r"\.k\d+\.(npz|jxkdb)$", "", base)
    return base.rsplit(".", 1)[-1]


def _load_db(path: str):
    """Load a per-sample k-mer table: .npz (jx kmer default) or the
    streamed binary .jxkdb (-stream-db); both expose codes/counts/k."""
    if path.endswith(".jxkdb"):
        from janusx_tpu_torch.models.kmer import load_kmer_db

        codes, counts, k = load_kmer_db(path)
        return {"codes": codes, "counts": counts, "k": np.asarray(k)}
    return np.load(path)


def kmerge_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jx kmerge",
                                description="merge per-sample k-mer counts to a presence matrix")
    p.add_argument("-i", "-db", "--db", "--inputs", dest="inputs", type=str,
                   nargs="+", required=True,
                   help="per-sample .npz count files from `jx kmer` "
                        "(reference spelling: -db)")
    p.add_argument("-sid", "--sample-id", nargs="+", default=None,
                   help="sample IDs in the same order as the inputs")
    p.add_argument("-min-samples", "--min-samples", type=int, default=2)
    p.add_argument("-freq", "--freq", type=float, default=None,
                   help="keep k-mers with presence rate in [freq, 1-freq] "
                        "(reference default 0.02); overrides -min-samples")
    p.add_argument("--min-count", type=int, default=1,
                   help="minimum within-sample count to call presence "
                        "(reference --min-count)")
    common.add_compat_flags(p, [
        ("--tmp-dir", {"type": str},
         "the merge runs in RAM on npz count tables; external-memory "
         "spill lives in `jx kmer -mem/-spill-dir`"),
        ("--max-run-size", {"type": int},
         "no sorted-run stage here (npz tables are pre-sorted)"),
        ("--bucket-bits", {"type": int},
         "no KMC bucket stage here (npz tables are pre-sorted)"),
        ("--batch-size", {"type": int},
         "no KMC streaming read stage here"),
        ("--resume", {"action": "store_true"},
         "the in-RAM merge has no tmp-dir stages to resume"),
        ("--keep-tmp", {"action": "store_true"},
         "the in-RAM merge writes no temporaries"),
        ("--force", {"action": "store_true"},
         "outputs are always overwritten here"),
    ])
    common.add_out_args(p, default_prefix="kmerged")
    args = p.parse_args(argv)
    prefix = common.out_prefix(args)
    common.warn_ignored_compat(p, args)

    from janusx_tpu_torch.io import plink
    from janusx_tpu_torch.models import kmer

    per_sample = {}
    k = None
    sids = (list(args.sample_id) if args.sample_id
            else [_sample_id(p_) for p_ in args.inputs])
    if len(sids) != len(args.inputs):
        raise SystemExit("-sid count must match the number of inputs")
    for sid, path in zip(sids, args.inputs):
        z = _load_db(path)
        codes, counts = z["codes"], z["counts"]
        if args.min_count > 1:
            keep = counts >= args.min_count
            codes, counts = codes[keep], counts[keep]
        per_sample[sid] = (codes, counts)
        kf = int(z["k"])
        if k is not None and kf != k:
            # codes from different k live in different integer spaces;
            # merging them would be silent data corruption
            raise SystemExit(
                f"{path} was counted with k={kf} but earlier inputs use "
                f"k={k}; re-run jx kmer with one k for all samples"
            )
        k = kf
    if args.freq is not None:
        # reference -freq: presence-rate band filter [freq, 1-freq]
        codes, mat, samples = kmer.merge_to_matrix(per_sample, min_samples=1)
        rate = (mat > 0).mean(axis=1)
        keep = (rate >= args.freq) & (rate <= 1.0 - args.freq)
        codes, mat = codes[keep], mat[keep]
    else:
        codes, mat, samples = kmer.merge_to_matrix(
            per_sample, min_samples=args.min_samples
        )
    gd = kmer.kmer_matrix_to_genotypes(codes, mat, samples, k)
    plink.write_plink_genotypes(prefix, gd)
    # BIN01 interchange matrix (presence bits + 2-bit k-mer sidecar —
    # reference kmerge emits JXBIN001, src/io/bincore.rs:7-32)
    from janusx_tpu_torch.io import bin01
    from janusx_tpu_torch.models.kmer import decode_kmer

    with bin01.Bin01Writer(prefix + ".bin", len(samples), "kmer") as bw:
        kmers = [decode_kmer(int(c), k) for c in codes]
        bw.write_rows(mat > 0, kmers)
    bin01.write_samples(prefix + ".bin", samples)
    print(f"{prefix}.bed + {prefix}.bin\t{gd.m} segregating k-mers x {gd.n} samples")
    return 0


def _kstats_kbin(args, prefix: str) -> int:
    """-kbin mode: per-sample presence stats (and -compare group tables)
    from a `jx kmerge` bitmatrix (reference kstats -kbin/-compare)."""
    from janusx_tpu_torch.io import bin01

    path = args.kbin
    if not path.endswith(".bin"):
        path = (path[: -len(".meta.json")] + ".bin"
                if path.endswith(".meta.json") else path + ".bin")
    mat = bin01.read_bin01(path)
    samples = list(bin01.read_samples(path, mat.n_samples))
    dense = mat.dense() > 0  # (m, n)
    print("sample\tn_kmers\tpresence_rate")
    for j, sid in enumerate(samples):
        nk = int(dense[:, j].sum())
        print(f"{sid}\t{nk}\t{nk / max(mat.m, 1):.4f}")
    if not args.compare:
        return 0
    if len(args.compare) < 2:
        raise SystemExit("-compare needs at least 2 groups")
    idx = {s: i for i, s in enumerate(samples)}
    groups = []
    for gi, spec in enumerate(args.compare):
        name, _, members = spec.partition("=")
        if not members:
            name, members = f"group{gi + 1}", spec
        cols = []
        for s in members.split(","):
            if s.strip() not in idx:
                raise SystemExit(f"-compare: unknown sample {s.strip()!r}")
            cols.append(idx[s.strip()])
        groups.append((name, dense[:, cols].any(axis=1)))
    out = f"{prefix}.compare.tsv"
    with open(out, "wt") as fh:
        fh.write("group_a\tgroup_b\tonly_a\tonly_b\tshared\tjaccard\n")
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                na, pa = groups[i]
                nb, pb = groups[j]
                shared = int((pa & pb).sum())
                union = int((pa | pb).sum())
                fh.write(f"{na}\t{nb}\t{int((pa & ~pb).sum())}\t"
                         f"{int((pb & ~pa).sum())}\t{shared}\t"
                         f"{shared / max(union, 1):.4f}\n")
    print(out)
    return 0


def kstats_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jx kstats", description="k-mer count statistics")
    p.add_argument("-i", "-db", "--db", "--inputs", dest="inputs", type=str,
                   nargs="+", default=None,
                   help="per-sample k-mer DBs (.npz from `jx kmer`)")
    p.add_argument("-kbin", "--kbin", type=str, default=None,
                   help="`jx kmerge` bitmatrix prefix (or its .bin path) — "
                        "per-sample presence stats from the merged matrix")
    p.add_argument("-compare", "--compare", nargs="+", default=None,
                   help="bitmatrix compare groups for -kbin mode: "
                        "NAME=sample1,sample2 or sample1,sample2 "
                        "(>= 2 groups)")
    p.add_argument("--min-count", type=int, default=1,
                   help="minimum within-sample count to keep "
                        "(reference --min-count)")
    p.add_argument("-sid", "--sample-id", nargs="+", default=None,
                   help="sample IDs in the same order as the inputs")
    p.add_argument("-pair", "--pair", choices=("union", "intersection", "both"),
                   default=None,
                   help="write pairwise lower-triangle set-size matrices")
    p.add_argument("-venn", "--venn", action="store_true",
                   help="presence-pattern counts (classic 2-sample row; one "
                        "row per observed pattern for >2 samples)")
    common.add_compat_flags(p, [
        ("--tmp-dir", {"type": str},
         "stats run in RAM on pre-counted tables"),
        ("--max-run-size", {"type": int}, "no sorted-run stage here"),
        ("--bucket-bits", {"type": int}, "no KMC bucket stage here"),
        ("--batch-size", {"type": int}, "no KMC streaming read stage here"),
        ("--keep-tmp", {"action": "store_true"}, "no temporaries written"),
        ("--force", {"action": "store_true"},
         "outputs are always overwritten here"),
    ])
    common.add_out_args(p, default_prefix="kstats")
    args = p.parse_args(argv)
    prefix = common.out_prefix(args)
    common.warn_ignored_compat(p, args)
    if (args.inputs is None) == (args.kbin is None):
        raise SystemExit("specify exactly one of -db or -kbin")
    if args.kbin is not None:
        return _kstats_kbin(args, prefix)

    dbs = [_load_db(path) for path in args.inputs]
    sids = (list(args.sample_id) if args.sample_id
            else [_sample_id(p_) for p_ in args.inputs])
    if len(sids) != len(dbs):
        raise SystemExit("-sid count must match the number of inputs")
    # --min-count applies to EVERY view below (per-sample stats, -pair
    # matrices, -venn patterns), not just the stats table
    dbs = [
        {"codes": z["codes"][z["counts"] >= args.min_count],
         "counts": z["counts"][z["counts"] >= args.min_count]}
        if args.min_count > 1 else z
        for z in dbs
    ]
    print("sample\tn_kmers\ttotal_count\tmean_count\tmax_count")
    for sid, z in zip(sids, dbs):
        c = z["counts"]
        print(
            f"{sid}\t{len(c)}\t{int(c.sum())}\t{c.mean():.2f}\t{int(c.max()) if len(c) else 0}"
        )
    outputs = []
    if args.pair:
        codes = [np.sort(z["codes"]) for z in dbs]
        n = len(codes)
        inter = np.zeros((n, n), np.int64)
        union = np.zeros((n, n), np.int64)
        for i in range(n):
            inter[i, i] = union[i, i] = len(codes[i])
            for j in range(i):
                ni = len(np.intersect1d(codes[i], codes[j], assume_unique=True))
                inter[i, j] = inter[j, i] = ni
                union[i, j] = union[j, i] = len(codes[i]) + len(codes[j]) - ni

        def _write(mat, tag):
            path = f"{prefix}.pair.{tag}.tsv"
            with open(path, "wt") as fh:
                fh.write("\t" + "\t".join(sids) + "\n")
                for i in range(n):
                    # lower triangle (reference: lower-triangle matrices)
                    row = "\t".join(str(mat[i, j]) if j <= i else ""
                                    for j in range(n))
                    fh.write(f"{sids[i]}\t{row}\n")
            outputs.append(path)

        if args.pair in ("union", "both"):
            _write(union, "union")
        if args.pair in ("intersection", "both"):
            _write(inter, "intersection")
    if args.venn:
        if len(dbs) > 64:
            raise SystemExit(
                f"-venn supports at most 64 inputs (got {len(dbs)}): the "
                f"presence pattern is a 64-bit mask"
            )
        all_codes = np.unique(np.concatenate([z["codes"] for z in dbs]))
        pattern = np.zeros(len(all_codes), np.uint64)
        for i, z in enumerate(dbs):
            idx = np.searchsorted(all_codes, np.sort(z["codes"]))
            pattern[idx] |= np.uint64(1 << i)
        pats, counts = np.unique(pattern, return_counts=True)
        path = f"{prefix}.venn.tsv"
        with open(path, "wt") as fh:
            fh.write("pattern\t" + "\t".join(sids) + "\tcount\n")
            for pat, cnt in zip(pats, counts):
                bits = [(int(pat) >> i) & 1 for i in range(len(dbs))]
                fh.write("".join(map(str, bits)) + "\t"
                         + "\t".join(map(str, bits)) + f"\t{cnt}\n")
        if len(dbs) == 2:
            only_a = int(counts[list(pats).index(1)]) if 1 in pats else 0
            only_b = int(counts[list(pats).index(2)]) if 2 in pats else 0
            shared = int(counts[list(pats).index(3)]) if 3 in pats else 0
            print(f"venn\tonly_{sids[0]}={only_a}\tonly_{sids[1]}={only_b}"
                  f"\tshared={shared}")
        outputs.append(path)
    if outputs:
        print("\t".join(outputs))
    return 0
