"""`jx gformat` — genotype format conversion + filtering.

Reference: python/janusx/script/gformat.py (3.9k LoC: -fmt conversion,
QC filters, -keep sample lists, -extract site/range lists, -chr /
-from-bp/-to-bp region filters, kb/bp-window LD pruning, -snp-name
templated renaming) over src/io/gmerge.rs convert.
"""

from __future__ import annotations

import argparse
import re

import numpy as np

from janusx_tpu_torch.cli import common

_FMTS = ("plink", "vcf", "hmp", "txt", "npy")


def build_parser(prog="jx gformat") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Convert genotype formats")
    common.add_genotype_args(p)
    o = p.add_argument_group("Output")
    o.add_argument("-fmt", "--fmt", dest="format", choices=_FMTS, default=None,
                   help="output genotype format (default: plink)")
    # legacy spellings kept as aliases of -fmt
    o.add_argument("-make-bed", "--make-bed", action="store_true", help=argparse.SUPPRESS)
    o.add_argument("-make-vcf", "--make-vcf", action="store_true", help=argparse.SUPPRESS)
    o.add_argument("-make-hmp", "--make-hmp", action="store_true", help=argparse.SUPPRESS)
    o.add_argument("-make-txt", "--make-txt", action="store_true", help=argparse.SUPPRESS)
    common.add_qc_args(p)
    # conversion is lossless by default (reference gformat.py:2484-2500:
    # maf 0.0 / geno 1.0 = no filtering), unlike the analysis modules
    p.set_defaults(maf=0.0, geno=1.0)
    f = p.add_argument_group("Filters")
    f.add_argument("-keep", "--keep", type=str, default=None, metavar="FILE",
                   help="keep only samples listed in FILE (one ID per line)")
    f.add_argument("-extract", "--extract", nargs="+", default=None,
                   metavar=("MODE_OR_FILE", "FILE"),
                   help="keep only listed variants: '--extract <file>' with "
                        "CHR POS / CHR:POS / CHR_POS tokens, or "
                        "'--extract range <file>' with CHR START END rows")
    f.add_argument("-chr", "--chr", dest="chr_filter", nargs="+", default=None,
                   help="keep only selected chromosome(s); commas and numeric "
                        "ranges accepted, e.g. '--chr 1-4,22,XY'")
    f.add_argument("-from-bp", "--from-bp", type=int, default=None,
                   help="inclusive position lower bound (single --chr required)")
    f.add_argument("-to-bp", "--to-bp", type=int, default=None,
                   help="inclusive position upper bound (single --chr required)")
    f.add_argument("-prune", "--prune", nargs=3, metavar=("WIN", "STEP", "R2"),
                   default=None,
                   help="LD prune (MAF priority): window (variant count, or "
                        "kb/bp suffix for physical windows), step, r2. "
                        "e.g. --prune 50 5 0.2 | --prune 500kb 50 0.2")
    f.add_argument("-snps-only", "--snps-only", action="store_true",
                   help="keep only simple A/C/G/T SNPs (alias of --biallelic-only)")
    f.add_argument("-biallelic-only", "--biallelic-only", action="store_true",
                   help="keep only simple A/C/G/T SNPs")
    f.add_argument("-snp-name", "--snp-name", type=str, default=None,
                   metavar="TEMPLATE",
                   help="rename output SNPs from CHR/POS: 'chr_pos', 'chr*pos', "
                        "'{chr}_{pos}', 'chr{chr}_{pos}'")
    common.add_compat_thread_arg(p)
    common.add_out_args(p, default_prefix="jxout")
    return p


# ------------------------------------------------------------- helpers
# token/selector semantics mirror the reference parsers
# (gformat.py:_normalize_chr_key/_parse_site_token/_expand_chr_selector)


def _norm_chr(c: str) -> str:
    s = str(c).strip()
    if s.lower().startswith("chr"):
        s = s[3:]
    s = s.strip().upper()
    return "MT" if s == "M" else s


def _split_tokens(line: str) -> list:
    return [x for x in re.split(r"[,\s]+", line.strip()) if x]


def _read_keep(path: str) -> list:
    out, seen = [], set()
    for line in open(path):
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        tok = _split_tokens(s)
        if tok and tok[0] not in seen:
            seen.add(tok[0])
            out.append(tok[0])
    if not out:
        raise SystemExit(f"--keep file is empty or invalid: {path}")
    return out


def _parse_site_token(tok: str):
    t = tok.strip()
    for sep in (":", "_"):
        if sep in t:
            c, p = t.split(sep, 1)
            return _norm_chr(c), int(p)
    raise SystemExit(f"unsupported site token {tok!r}: use CHR:POS / CHR_POS "
                     "or two columns CHR POS")


def _parse_extract(values):
    """-> ('sites', set[(chr,pos)]) or ('range', list[(chr,lo,hi)])."""
    parts = [str(v).strip() for v in values if str(v).strip()]
    if len(parts) == 1:
        mode, path = "sites", parts[0]
    elif len(parts) == 2 and parts[0].lower() == "range":
        mode, path = "range", parts[1]
    else:
        raise SystemExit("invalid --extract usage: '--extract <file>' or "
                         "'--extract range <file>'")
    sites, ranges = set(), []
    for line in open(path):
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        tok = _split_tokens(s)
        if mode == "sites":
            if len(tok) >= 2:
                sites.add((_norm_chr(tok[0]), int(tok[1])))
            else:
                sites.add(_parse_site_token(tok[0]))
        else:
            if len(tok) < 3:
                raise SystemExit(f"range rows need CHR START END: {s!r}")
            ranges.append((_norm_chr(tok[0]), int(tok[1]), int(tok[2])))
    return (mode, sites if mode == "sites" else ranges)


def _expand_chr(tokens) -> set:
    out = set()
    for tok in tokens:
        for part in str(tok).split(","):
            q = part.strip()
            if not q:
                continue
            if "-" in q:
                a, b = (x.strip() for x in q.split("-", 1))
                if a.isdigit() and b.isdigit():
                    if int(a) > int(b):
                        raise SystemExit(f"invalid --chr range: {q}")
                    out.update(_norm_chr(str(k))
                               for k in range(int(a), int(b) + 1))
                    continue
            out.add(_norm_chr(q))
    return out


def _parse_prune_window(tok: str):
    """-> (window_variants | None, window_bp | None)."""
    t = str(tok).strip().lower()
    if t.endswith("kb"):
        return None, int(float(t[:-2]) * 1000)
    if t.endswith("bp"):
        return None, int(t[:-2])
    if not t.isdigit():
        raise SystemExit(f"invalid prune window {tok!r}: variant count, or "
                         "kb/bp suffix for a physical window")
    return int(t), None


def _snp_name_template(text: str) -> str:
    t = text.strip()
    if not t or any(ch.isspace() for ch in t):
        raise SystemExit("--snp-name cannot be empty or contain whitespace")
    if ("{chr}" in t) or ("{pos}" in t):
        if not ("{chr}" in t and "{pos}" in t):
            raise SystemExit("--snp-name must contain both {chr} and {pos}")
        return t
    if "chr" not in t or "pos" not in t:
        raise SystemExit("--snp-name must contain both chr and pos placeholders")
    return t


def _format_snp_name(template: str, chrom, pos) -> str:
    c, s = str(chrom).strip(), str(int(pos))
    if "{chr}" in template:
        return template.replace("{chr}", c).replace("{pos}", s)
    return template.replace("chr", c).replace("pos", s)


# ------------------------------------------------------------- main


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "gformat")

    from janusx_tpu_torch.io import plink, writers
    from janusx_tpu_torch.io.gdata import GenotypeData
    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.packed import QcParams

    if args.format is not None:
        fmts = [args.format]
    else:
        # legacy -make-* spellings may request several formats at once
        fmts = [name for flag, name in
                (("make_bed", "plink"), ("make_vcf", "vcf"),
                 ("make_hmp", "hmp"), ("make_txt", "txt"))
                if getattr(args, flag)] or ["plink"]
    template = _snp_name_template(args.snp_name) if args.snp_name else None
    if (args.from_bp is not None or args.to_bp is not None):
        if not args.chr_filter or len(_expand_chr(args.chr_filter)) != 1:
            raise SystemExit("--from-bp/--to-bp require a single --chr")

    raw = load_raw_packed(common.resolve_genotype(args))

    sample_idx = None
    if args.keep:
        want = _read_keep(args.keep)
        pos = {str(s): i for i, s in enumerate(raw.samples)}
        missing = [w for w in want if w not in pos]
        if missing:
            raise SystemExit(f"{len(missing)} --keep IDs absent from genotypes, "
                             f"e.g. {missing[:3]}")
        sample_idx = np.array([pos[w] for w in want], np.int64)

    qc = QcParams(maf=args.maf, geno=args.geno, het=args.het,
                  snps_only=args.biallelic_only or args.snps_only)
    pg = raw.prepare(qc, sample_idx=sample_idx)

    # region/site filters
    mask = np.ones(pg.m, bool)
    chrom_keys = np.array([_norm_chr(c) for c in pg.sites.chrom])
    pos_arr = np.asarray(pg.sites.pos, np.int64)
    if args.chr_filter:
        mask &= np.isin(chrom_keys, list(_expand_chr(args.chr_filter)))
        if args.from_bp is not None:
            mask &= pos_arr >= args.from_bp
        if args.to_bp is not None:
            mask &= pos_arr <= args.to_bp
    if args.extract:
        mode, data = _parse_extract(args.extract)
        if mode == "sites":
            keys = set(data)
            mask &= np.fromiter(
                ((c, p) in keys for c, p in zip(chrom_keys, pos_arr)),
                bool, count=pg.m)
        else:
            rmask = np.zeros(pg.m, bool)
            for c, lo, hi in data:
                rmask |= (chrom_keys == c) & (pos_arr >= lo) & (pos_arr <= hi)
            mask &= rmask
    if not mask.all():
        pg = pg.take_snps(np.nonzero(mask)[0])
    if pg.m == 0:
        raise SystemExit("no variants left after filtering")

    if args.prune:
        from janusx_tpu_torch.models.ldprune import ld_prune

        win_var, win_bp = _parse_prune_window(args.prune[0])
        keep = ld_prune(pg, window=win_var or 50, step=int(args.prune[1]),
                        r2_threshold=float(args.prune[2]), window_bp=win_bp)
        pg = pg.take_snps(keep)

    sites = pg.sites
    if template is not None:
        from dataclasses import replace as _dc_replace

        sites = _dc_replace(sites, snp=np.array(
            [_format_snp_name(template, c, p)
             for c, p in zip(sites.chrom, sites.pos)], dtype=object))

    gd = GenotypeData(pg.dosages(), sites, pg.samples)
    outputs = []
    for fmt in fmts:
        if fmt == "plink":
            plink.write_plink_genotypes(prefix, gd)
            outputs.append(prefix + ".bed")
        elif fmt == "vcf":
            writers.write_vcf(prefix + ".vcf.gz", gd)
            outputs.append(prefix + ".vcf.gz")
        elif fmt == "hmp":
            writers.write_hapmap(prefix + ".hmp.txt", gd)
            outputs.append(prefix + ".hmp.txt")
        elif fmt == "txt":
            writers.write_txt(prefix + ".txt", gd)
            outputs.append(prefix + ".txt")
        elif fmt == "npy":
            np.save(prefix + ".npy", gd.genotypes.astype(np.int8))
            with open(prefix + ".id", "wt") as fh:
                fh.write("\n".join(str(s) for s in gd.samples) + "\n")
            with open(prefix + ".sites.tsv", "wt") as fh:
                fh.write("chrom\tpos\tsnp\tallele0\tallele1\n")
                for i in range(len(sites.pos)):
                    fh.write(f"{sites.chrom[i]}\t{sites.pos[i]}\t{sites.snp[i]}"
                             f"\t{sites.allele0[i]}\t{sites.allele1[i]}\n")
            outputs.append(prefix + ".npy")
    print(f"{pg.m} SNPs x {pg.n} samples ->\t" + "\t".join(outputs))
    return 0
