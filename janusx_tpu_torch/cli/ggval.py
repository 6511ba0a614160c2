"""`jx ggval` — end-to-end CLI validation suites.

Reference: JanusX python/janusx/ggval.py (suites :30-41, flow
:1242-1340): simulate genotypes + trait, run the module CLIs against the
simulated data, then verify STRUCTURALLY — expected files exist, TSV
headers are exact, effect/assoc row counts match the marker count,
plots are produced. Not a numeric-parity harness (the pytest suite
covers numerics); this is the user-facing "is my install sane" check.

Suites: gwas, gs, grm-pca, reml, post; smoke default = {gwas, gs}.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import traceback

from janusx_tpu_torch.cli import common

ASSOC_HEADER = (
    "chrom\tpos\tsnp\tallele0\tallele1\taf\tmiss\tbeta\tse\tchisq\tpwald"
)

SUITES = ("gwas", "gs", "gs-vcf", "gs-hmp", "gs-ml", "grm-pca", "reml", "post")


def build_parser(prog="jx ggval") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="End-to-end CLI validation")
    p.add_argument("suites", nargs="*", default=[],
                   help=f"suites to run ({', '.join(SUITES)}; 'all'; "
                        "default: gwas gs)")
    p.add_argument("-nind", "--nind", type=int, default=200)
    p.add_argument("-nsnp", "--nsnp", type=int, default=600)
    p.add_argument("-keep", "--keep", type=str, default=None,
                   help="keep work dir at this path (default: temp, removed)")
    p.add_argument("--mode", choices=("smoke", "full"), default=None,
                   help="smoke = {gwas, gs}; full = all suites "
                        "(reference --mode; positional suites win)")
    p.add_argument("--only", type=str, default=None,
                   help="run only the named suites (comma separated)")
    p.add_argument("--skip", type=str, default=None,
                   help="skip the named suites (comma separated)")
    p.add_argument("--outdir", type=str, default=None,
                   help="work/output directory (same as -keep)")
    p.add_argument("--cv", type=int, default=2,
                   help="CV folds used by the gs suites")
    p.add_argument("--no-postgs", action="store_true",
                   help="skip the post-analysis suite")
    p.add_argument("--multicore", action="store_true",
                   help="run only the GRM/EIGH benchmark suite on a larger "
                        "dataset (reference --multicore)")
    common.add_compat_flags(p, [
        ("--threads", {"type": int},
         "XLA and the host BLAS size their own pools"),
        ("--logdir", {"type": str},
         "per-run logs land next to the outputs ({prefix}.ggval.log)"),
        ("--no-backend-thread-checks", {"action": "store_true"},
         "no BLAS backend/thread probing exists here"),
        (("-tgarfield-avx2", "--garfield-avx2"), {"action": "store_true"},
         "no AVX2-specific GARFIELD path: the search runs on XLA"),
    ])
    common.add_out_args(p, default_prefix="ggval")
    return p


class _Check:
    def __init__(self):
        self.results: list[tuple[str, bool, str]] = []

    def ok(self, name: str, cond: bool, note: str = ""):
        self.results.append((name, bool(cond), note))

    def file(self, name: str, path: str):
        self.ok(name, os.path.isfile(path) and os.path.getsize(path) > 0, path)

    def header(self, name: str, path: str, expected: str):
        try:
            with open(path) as fh:
                got = fh.readline().rstrip("\n")
            self.ok(name, got == expected,
                    "" if got == expected else f"got: {got[:80]}")
        except OSError as e:
            self.ok(name, False, str(e))

    def rows(self, name: str, path: str, expected: int):
        try:
            with open(path) as fh:
                nrows = sum(1 for _ in fh) - 1
            self.ok(name, nrows == expected, f"{nrows} vs {expected}")
        except OSError as e:
            self.ok(name, False, str(e))


def _count_bim(base: str) -> int:
    with open(base + ".bim") as fh:
        return sum(1 for _ in fh)


def _sim(work: str, nind: int, nsnp: int) -> str:
    from janusx_tpu_torch.cli.sim import main as sim_main

    rc = sim_main(["-nind", str(nind), "-nsnp", str(nsnp), "-nqtl", "10",
                   "-h2", "0.6", "-o", work])
    if rc != 0:
        raise RuntimeError("jx sim failed")
    return os.path.join(work, "sim")


def run_suites(suites, work: str, nind: int, nsnp: int,
               chk: _Check, cv: int = 2) -> None:
    base = _sim(work, nind, nsnp)
    m = _count_bim(base)
    pheno = base + ".pheno"
    chk.ok("sim: bed/bim/fam/pheno", all(
        os.path.isfile(base + ext) for ext in (".bed", ".bim", ".fam", ".pheno")
    ))

    if "gwas" in suites:
        from janusx_tpu_torch.cli.gwas import main as gwas_main

        out = os.path.join(work, "gwas")
        # QC off (-maf 0 -geno 1): the rows==m checks below compare
        # against the raw .bim count; default MAF filtering could drop
        # borderline simulated SNPs and fail a healthy install
        rc = gwas_main(["-bfile", base, "-p", pheno, "-lm", "-lmm",
                        "-force-model", "-maf", "0", "-geno", "1",
                        "-o", out])
        chk.ok("gwas: exit 0", rc == 0)
        for tag in ("LM", "LMM"):
            tsv = os.path.join(out, f"jx.trait0.{tag}.assoc.tsv")
            chk.file(f"gwas: {tag} tsv", tsv)
            chk.header(f"gwas: {tag} header", tsv, ASSOC_HEADER)
            chk.rows(f"gwas: {tag} rows==m", tsv, m)
        chk.file("gwas: summary.json",
                 os.path.join(out, "jx.gwas.summary.json"))

    if "gs" in suites:
        from janusx_tpu_torch.cli.gs import main as gs_main

        # blank the last 20 phenotypes -> prediction (test) set, so the
        # gebv artifact is exercised (reference gs: test = missing pheno)
        pheno_gs = os.path.join(work, "gs.pheno")
        with open(pheno) as fh:
            lines = fh.read().splitlines()
        body = lines[1:]
        for i in range(max(len(body) - 20, 0), len(body)):
            sid = body[i].split("\t")[0]
            body[i] = f"{sid}\tNA"
        with open(pheno_gs, "wt") as fh:
            fh.write("\n".join([lines[0]] + body) + "\n")
        out = os.path.join(work, "gs")
        rc = gs_main(["-bfile", base, "-p", pheno_gs, "-BLUP", "-cv", str(cv),
                      "-o", out])
        chk.ok("gs: exit 0", rc == 0)
        chk.file("gs: gebv.tsv", os.path.join(out, "jxgs.trait0.gebv.tsv"))
        chk.file("gs: summary.json", os.path.join(out, "jxgs.gs.summary.json"))

    if any(sv in suites for sv in ("gs-vcf", "gs-hmp", "gs-ml")):
        # reference ggval suites gs-vcf / gs-hmp / gs-ml (ggval.py:30-41):
        # the same GS flow through converted inputs and the ML backends
        from janusx_tpu_torch.cli.gformat import main as gformat_main
        from janusx_tpu_torch.cli.gs import main as gs_main

        for fmt, suite in (("vcf", "gs-vcf"), ("hmp", "gs-hmp")):
            if suite not in suites:
                continue
            conv = os.path.join(work, f"conv_{fmt}")
            rc = gformat_main(["-bfile", base, "-fmt", fmt, "-o", conv,
                               "-prefix", "c"])
            chk.ok(f"{suite}: convert exit 0", rc == 0)
            src = os.path.join(conv, "c.vcf.gz" if fmt == "vcf" else "c.hmp.txt")
            out = os.path.join(work, suite)
            flag = "-vcf" if fmt == "vcf" else "-hmp"
            rc = gs_main([flag, src, "-p", pheno, "-BLUP", "-cv", str(cv),
                          "-o", out])
            chk.ok(f"{suite}: exit 0", rc == 0)
            chk.file(f"{suite}: summary.json",
                     os.path.join(out, "jxgs.gs.summary.json"))
        if "gs-ml" in suites:
            out = os.path.join(work, "gs_ml")
            rc = gs_main(["-bfile", base, "-p", pheno, "-RF", "-ENET",
                          "-cv", str(cv), "-o", out])
            chk.ok("gs-ml: exit 0", rc == 0)
            import json as _json

            summ = _json.load(open(os.path.join(out, "jxgs.gs.summary.json")))
            chk.ok("gs-ml: RF+ENET ran",
                   set(summ["methods"]) >= {"RF", "ENET"})

    if "grm-pca" in suites:
        from janusx_tpu_torch.cli.grm import main as grm_main
        from janusx_tpu_torch.cli.pca import main as pca_main

        out = os.path.join(work, "grm")
        chk.ok("grm: exit 0", grm_main(["-bfile", base, "-o", out]) == 0)
        npys = [f for f in os.listdir(out) if f.endswith(".npy")]
        chk.ok("grm: npy + id", bool(npys) and any(
            f.endswith(".id") for f in os.listdir(out)
        ), ",".join(sorted(os.listdir(out))[:4]))
        out2 = os.path.join(work, "pca")
        chk.ok("pca: exit 0",
               pca_main(["-bfile", base, "-dim", "5", "-o", out2]) == 0)
        chk.ok("pca: eigenvec", any(
            "eigenvec" in f for f in os.listdir(out2)
        ), ",".join(os.listdir(out2)[:4]))

    if "reml" in suites:
        from janusx_tpu_torch.cli.grm import main as grm_main
        from janusx_tpu_torch.cli.reml import main as reml_main

        gdir = os.path.join(work, "grm4reml")
        grm_main(["-bfile", base, "-o", gdir])
        k = next(
            os.path.join(gdir, f) for f in os.listdir(gdir)
            if f.endswith(".npy")
        )
        out = os.path.join(work, "reml")
        rc = reml_main(["-p", pheno, "-n", "trait0", "-k", k, "-o", out])
        chk.ok("reml: exit 0", rc == 0)
        chk.ok("reml: outputs", bool(os.listdir(out)), ",".join(os.listdir(out)[:4]))

    if "post" in suites:
        from janusx_tpu_torch.cli.gwas import main as gwas_main
        from janusx_tpu_torch.cli.postgwas import main as pg_main

        out = os.path.join(work, "gwas4post")
        gwas_main(["-bfile", base, "-p", pheno, "-lm", "-force-model", "-o", out])
        tsv = os.path.join(out, "jx.trait0.LM.assoc.tsv")
        out2 = os.path.join(work, "post")
        rc = pg_main(["-i", tsv, "-o", out2])
        chk.ok("postgwas: exit 0", rc == 0)
        files = os.listdir(out2)
        chk.ok("postgwas: manhattan png", any("manhattan" in f for f in files))
        chk.ok("postgwas: qq png", any(".qq." in f for f in files))
        chk.ok("postgwas: top tsv", any(".top." in f for f in files))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "ggval")

    suites = list(args.suites)
    if "all" in suites or args.mode == "full":
        suites = list(SUITES)
    if args.only:
        suites = [t.strip() for t in args.only.replace(",", " ").split()
                  if t.strip()]
    if not suites:
        suites = ["gwas", "gs"]  # smoke default (reference ggval.py:40)
    if args.skip:
        drop = {t.strip() for t in args.skip.replace(",", " ").split()}
        suites = [s_ for s_ in suites if s_ not in drop]
    if args.no_postgs:
        suites = [s_ for s_ in suites if s_ != "post"]
    bad = [s for s in suites if s not in SUITES]
    if bad:
        raise SystemExit(f"unknown suites: {bad} (choose from {SUITES})")

    common.warn_ignored_compat(build_parser(), args)
    if args.multicore:
        # reference --multicore: only the GRM/EIGH benchmark, bigger data
        from janusx_tpu_torch.cli.benchmark import main as bench_main

        out = args.keep or args.outdir or tempfile.mkdtemp(prefix="jx_ggval_")
        rc = bench_main(["-nind", str(max(args.nind, 1000)),
                         "-nsnp", str(max(args.nsnp, 20000)),
                         "-modules", "grm,pca", "-o", out])
        print(f"multicore GRM/EIGH benchmark: "
              f"{'PASS' if rc == 0 else 'FAIL'} ({out})")
        return rc
    chk = _Check()
    tmp = None
    if args.outdir and not args.keep:
        args.keep = args.outdir
    if args.keep:
        work = args.keep
        os.makedirs(work, exist_ok=True)
    else:
        tmp = tempfile.TemporaryDirectory(prefix="jx_ggval_")
        work = tmp.name
    try:
        run_suites(suites, work, args.nind, args.nsnp, chk, cv=args.cv)
    except Exception:
        traceback.print_exc()
        chk.ok("suite execution", False, "exception (see traceback)")
    finally:
        if tmp is not None:
            tmp.cleanup()

    n_fail = sum(1 for _, ok, _ in chk.results if not ok)
    width = max(len(name) for name, _, _ in chk.results) if chk.results else 10
    for name, ok, note in chk.results:
        mark = "PASS" if ok else "FAIL"
        print(f"{name:<{width}}  {mark}  {note if not ok else ''}".rstrip())
    print(f"\n{len(chk.results) - n_fail}/{len(chk.results)} checks passed"
          f" ({', '.join(suites)})")
    return 0 if n_fail == 0 else 1
