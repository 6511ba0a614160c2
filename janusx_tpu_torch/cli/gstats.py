"""`jx gstats` for the port — per-site / per-sample genotype statistics
(reference: src/stats/gstats.rs + script/gstats.py).

A copy of janusx_tpu/cli/gstats.py but for ``_site_ldscores``, whose r²
chunks and per-site window sums run on the device; KING's tile products
run on the device through ``models/king.py``."""

from __future__ import annotations

import argparse

import numpy as np

from janusx_tpu_torch.cli import common


def build_parser(prog="jx gstats") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Genotype statistics")
    common.add_genotype_args(p)
    o = p.add_argument_group("Options")
    o.add_argument("-site", "--site", action="store_true", help="per-site stats (default)")
    o.add_argument("-ind", "--ind", action="store_true", help="per-sample stats")
    o.add_argument("-ldscore", "--ldscore", type=int, default=None, metavar="WIN",
                   help="also compute per-site LD scores over a WIN-SNP window")
    o.add_argument("-king", "--king", nargs="?", type=float, const=0.0884,
                   default=None, metavar="THRESH",
                   help="KING-robust related pairs above THRESH (default "
                   "0.0884 = 2nd degree) + greedy unrelated set; tiled "
                   "sweep, scales to biobank n")
    o.add_argument("-king-tile", "--king-tile", type=int, default=8192)
    r = p.add_argument_group("Reference stat tables (script/gstats.py parity)")
    r.add_argument("-freq", "--freq", action="store_true",
                   help="write site MAF table <prefix>.freq + histogram PDF")
    r.add_argument("-miss", "--miss", action="store_true",
                   help="write <prefix>.imiss / <prefix>.lmiss + distribution PDF")
    r.add_argument("-het", "--het-tables", dest="het_tables", action="store_true",
                   help="write <prefix>.ihet / <prefix>.lhet + distribution PDF")
    r.add_argument("-ldsc", "--ldsc", nargs="?", const="100kb", default=None,
                   metavar="WINDOW",
                   help="site LD scores <prefix>.<window>.ldsc + Manhattan PDF; "
                        "WINDOW = SNP count (100) or physical (100kb/0.1mb/"
                        "100000b); default 100kb")
    common.add_compat_thread_arg(p)
    common.add_out_args(p, default_prefix="jx")
    return p


def _parse_ldsc_window(text: str):
    """-> (kind 'variants'|'bp', value, label). Reference gstats.py:100-137."""
    import re

    raw = str(text).strip().lower().replace(" ", "")
    m = re.fullmatch(r"([0-9]*\.?[0-9]+)([a-z]*)", raw)
    if m is None:
        raise SystemExit(f"invalid -ldsc window {text!r}: use 100, 100kb, "
                         "0.1mb, or 100000b")
    value, unit = float(m.group(1)), m.group(2)
    if value <= 0:
        raise SystemExit(f"-ldsc window must be > 0, got {text!r}")
    if unit in ("", "snp", "snps"):
        v = int(round(value))
        return "variants", v, f"{v}snp"
    if unit in ("b", "bp"):
        return "bp", int(round(value)), f"{int(round(value))}b"
    if unit == "kb":
        return "bp", int(round(value * 1e3)), raw
    if unit == "mb":
        return "bp", int(round(value * 1e6)), raw
    raise SystemExit(f"unsupported -ldsc unit in {text!r} (cm windows need a "
                     "genetic map; use snp/bp/kb/mb)")


def _hist_pdf(values, path: str, xlabel: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    v = np.asarray(values, float)
    v = v[np.isfinite(v)]
    fig, ax = plt.subplots(figsize=(4.4, 3.2))
    ax.hist(v, bins=50, color="#4C72B0")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("count")
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def _ldsc_manhattan_pdf(chrom, pos, vals, path: str) -> None:
    """Manhattan-style genome panel of raw LD scores (not p-values)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = ("#4C72B0", "#DD8452")
    fig, ax = plt.subplots(figsize=(8.5, 3))
    offset = 0
    ticks, labels = [], []
    for ci, c in enumerate(dict.fromkeys(chrom.tolist())):
        m = chrom == c
        x = offset + (pos[m] - pos[m].min())
        ax.scatter(x, vals[m], s=4, lw=0, c=colors[ci % 2])
        ticks.append(offset + (pos[m].max() - pos[m].min()) / 2)
        labels.append(str(c))
        offset += pos[m].max() - pos[m].min() + 1
    ax.set_xticks(ticks)
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_xlabel("Chromosome")
    ax.set_ylabel("LD score")
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def _sample_counts(raw, n: int, m: int):
    """Per-sample (missing, het) counts, streamed over row windows so
    neither the int8 decode nor (for WindowedBed inputs) the packed
    matrix is ever fully materialized."""
    from janusx_tpu_torch.io import bitcodec

    missing = np.zeros(n, np.int64)
    hets = np.zeros(n, np.int64)
    for s0 in range(0, m, 4096):
        codes = bitcodec.unpack_codes(
            raw.read_window_codes(s0, min(s0 + 4096, m)), n
        )
        missing += (codes == 3).sum(axis=0)
        hets += (codes == 1).sum(axis=0)
    return missing, hets


def _row_stats_streamed(raw, n: int):
    """bitcodec.row_stats over row windows (WindowedBed-safe)."""
    from janusx_tpu_torch.io import bitcodec

    parts = []
    for s0 in range(0, raw.m, 65536):
        parts.append(bitcodec.row_stats(
            raw.read_window_codes(s0, min(s0 + 65536, raw.m)), n
        ))
    if not parts:
        z = np.zeros(0, np.int64)
        return z, z, z
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))


def _site_ldscores(raw, kind: str, win, device=None) -> np.ndarray:
    """Per-site sum of r² with in-window neighbors (window per chromosome).
    Pairwise-complete r² when missing calls exist (ld.rs semantics); the
    self term is subtracted explicitly so monomorphic sites score 0, not
    -1. Each chunk's r² matrix stays on the device, and so do the window
    sums of its rows (in f64); only the chunk's scores come back."""
    import torch

    from janusx_tpu_torch import config
    from janusx_tpu_torch.io.packed import QcParams, pack_from_codes
    from janusx_tpu_torch.models.ldprune import _corr_chunk, _r2_chunk_pairwise
    from janusx_tpu_torch.ops import decode as _dec

    dev = config.resolve_device(device)
    pgq = pack_from_codes(raw.packed, raw.n_samples, raw.sites, raw.samples,
                          QcParams(maf=0.0, geno=1.0))
    any_missing = bool(np.any(pgq.miss > 0))
    m = pgq.m
    ld = np.zeros(m)
    packed_pad = _dec.pad_packed_cols(pgq.packed)
    pos = np.asarray(pgq.sites.pos, np.int64)
    chrom = pgq.sites.chrom
    bounds = [0] + [i for i in range(1, m) if chrom[i] != chrom[i - 1]] + [m]
    step = 2048
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        if kind == "bp":
            ends = np.searchsorted(pos[c0:c1], pos[c0:c1] + win, "right")
            starts = np.searchsorted(pos[c0:c1], pos[c0:c1] - win, "left")
            ov = int(max(np.max(ends - np.arange(c1 - c0)),
                         np.max(np.arange(c1 - c0) - starts))) if c1 > c0 else 1
        else:
            ov = int(win)
        for s0 in range(c0, c1, step):
            # two-sided overlap: rows at the chunk edges still see their
            # full left AND right windows
            a0 = max(c0, s0 - ov)
            e0 = min(s0 + step + ov, c1)
            pk = torch.as_tensor(packed_pad[a0:e0], device=dev)
            if any_missing:
                r2 = _r2_chunk_pairwise(pk)
            else:
                r = _corr_chunk(pk, torch.as_tensor(
                    pgq.mean[a0:e0].astype(np.float32), device=dev))
                r2 = r * r
            hi = min(s0 + step, c1)
            li = np.arange(s0, hi) - a0
            if kind == "bp":
                lo = np.searchsorted(pos[a0:e0], pos[s0:hi] - win, "left")
                up = np.searchsorted(pos[a0:e0], pos[s0:hi] + win, "right")
            else:
                lo = np.maximum(0, li - win)
                up = np.minimum(e0 - a0, li + win + 1)
            t = lambda a: torch.as_tensor(a, device=dev)[:, None]
            rows = r2[li[0]:li[-1] + 1].to(torch.float64)
            j = torch.arange(e0 - a0, device=dev)[None, :]
            inside = (j >= t(lo)) & (j < t(up))
            own = torch.diagonal(rows, offset=int(li[0]))
            ld[s0:hi] = (torch.where(inside, rows, 0.0).sum(dim=1) - own).cpu().numpy()
    return ld


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "gstats")

    from janusx_tpu_torch.io import bitcodec
    from janusx_tpu_torch.io.gfreader import load_raw_packed

    raw = load_raw_packed(common.resolve_genotype(args))
    if args.ldsc is not None or args.ldscore or args.king is not None:
        # these modes need whole-matrix random access; a low-memory
        # WindowedBed handle is materialized (RAM = .bed size)
        raw = raw.to_raw_packed()
    n = raw.n_samples
    ref_modes = args.freq or args.miss or args.het_tables or args.ldsc is not None
    do_site = args.site or not (args.ind or ref_modes or args.king is not None)
    outputs = []

    # shared full-matrix passes, computed once for every consumer below
    # (streamed over row windows — WindowedBed inputs never materialize)
    nm_r = alt_r = het_r = None
    if ref_modes or do_site:
        nm_r, alt_r, het_r = _row_stats_streamed(raw, n)
    i_missing = i_het = i_nm = None
    if args.miss or args.het_tables or args.ind:
        i_missing, i_het = _sample_counts(raw, n, raw.m)
        i_nm = raw.m - i_missing

    if ref_modes:
        with np.errstate(divide="ignore", invalid="ignore"):
            af_r = np.where(nm_r > 0, alt_r / (2.0 * nm_r), np.nan)
            maf_r = np.minimum(af_r, 1 - af_r)
            lhet = np.where(nm_r > 0, het_r / nm_r, np.nan)
        lmiss = 1.0 - nm_r / n
        s = raw.sites

        def _site_table(path, col, vals, fmt="%.6f"):
            with open(path, "wt") as fh:
                fh.write(f"chr\tpos\t{col}\n")
                for i in range(raw.m):
                    fh.write(f"{s.chrom[i]}\t{s.pos[i]}\t{fmt % vals[i]}\n")
            outputs.append(path)

        if args.freq:
            _site_table(f"{prefix}.freq", "maf", maf_r)
            _hist_pdf(maf_r, f"{prefix}.freq.pdf", "minor allele frequency")
            outputs.append(f"{prefix}.freq.pdf")
        if args.miss:
            _site_table(f"{prefix}.lmiss", "miss", lmiss)
            with open(f"{prefix}.imiss", "wt") as fh:
                fh.write("sample\tmiss\n")
                for j, sid in enumerate(raw.samples):
                    fh.write(f"{sid}\t{i_missing[j] / max(1, raw.m):.6f}\n")
            outputs.append(f"{prefix}.imiss")
            _hist_pdf(lmiss, f"{prefix}.miss.pdf", "site missing rate")
            outputs.append(f"{prefix}.miss.pdf")
        if args.het_tables:
            _site_table(f"{prefix}.lhet", "het", lhet)
            with open(f"{prefix}.ihet", "wt") as fh:
                fh.write("sample\thet\n")
                for j, sid in enumerate(raw.samples):
                    fh.write(f"{sid}\t{i_het[j] / max(1, i_nm[j]):.6f}\n")
            outputs.append(f"{prefix}.ihet")
            _hist_pdf(lhet, f"{prefix}.het.pdf", "site heterozygosity")
            outputs.append(f"{prefix}.het.pdf")
        if args.ldsc is not None:
            kind, win, label = _parse_ldsc_window(args.ldsc)
            ld_sc = _site_ldscores(raw, kind, win)
            path = f"{prefix}.{label}.ldsc"
            _site_table(path, "ldsc", ld_sc)
            _ldsc_manhattan_pdf(
                np.asarray(s.chrom, dtype=object), np.asarray(s.pos, np.int64),
                ld_sc, f"{prefix}.{label}.ldsc.pdf")
            outputs.append(f"{prefix}.{label}.ldsc.pdf")
    if do_site:
        with np.errstate(divide="ignore", invalid="ignore"):
            af = np.where(nm_r > 0, alt_r / (2.0 * nm_r), np.nan)
            maf = np.minimum(af, 1 - af)
            het_rate = np.where(nm_r > 0, het_r / nm_r, np.nan)
        miss = 1.0 - nm_r / n
        ld = None
        if args.ldscore:
            # count-window LD scores via the shared chunked kernel
            ld = _site_ldscores(raw, "variants", int(args.ldscore))
        path = f"{prefix}.site.stats.tsv"
        with open(path, "wt") as fh:
            hdr = "chrom\tpos\tsnp\tallele0\tallele1\taf\tmaf\tmiss\thet"
            if ld is not None:
                hdr += "\tldscore"
            fh.write(hdr + "\n")
            s = raw.sites
            for i in range(raw.m):
                row = (
                    f"{s.chrom[i]}\t{s.pos[i]}\t{s.snp[i]}\t{s.allele0[i]}\t{s.allele1[i]}"
                    f"\t{af[i]:.6g}\t{maf[i]:.6g}\t{miss[i]:.6g}\t{het_rate[i]:.6g}"
                )
                if ld is not None:
                    row += f"\t{ld[i]:.6g}"
                fh.write(row + "\n")
        outputs.append(path)
    if args.ind:
        path = f"{prefix}.ind.stats.tsv"
        with open(path, "wt") as fh:
            fh.write("sample\tn_snps\tmiss\thet\n")
            for j, sid in enumerate(raw.samples):
                miss_rate = i_missing[j] / raw.m if raw.m else 0.0
                het_rate = i_het[j] / i_nm[j] if i_nm[j] else 0.0
                fh.write(f"{sid}\t{raw.m}\t{miss_rate:.6g}\t{het_rate:.6g}\n")
        outputs.append(path)
    if args.king is not None:
        from janusx_tpu_torch.io.packed import QcParams, pack_from_codes
        from janusx_tpu_torch.models.king import (
            king_related_pairs,
            unrelated_set_from_pairs,
        )

        pgq = pack_from_codes(raw.packed, n, raw.sites, raw.samples,
                              QcParams(maf=0.01, geno=0.2))
        ii, jj, vv = king_related_pairs(
            pgq, threshold=args.king, tile=args.king_tile
        )
        path = f"{prefix}.king.pairs.tsv"
        with open(path, "wt") as fh:
            fh.write("sample_i\tsample_j\tkinship\n")
            for i, j, v in zip(ii, jj, vv):
                fh.write(f"{raw.samples[i]}\t{raw.samples[j]}\t{v:.6g}\n")
        keep = unrelated_set_from_pairs(ii, jj, n)
        upath = f"{prefix}.king.unrelated.id"
        with open(upath, "wt") as fh:
            for k in keep:
                fh.write(f"{raw.samples[k]}\n")
        print(f"KING: {len(ii)} related pairs > {args.king}; "
              f"unrelated set {len(keep)}/{n}")
        outputs += [path, upath]
    print("\t".join(outputs))
    return 0
