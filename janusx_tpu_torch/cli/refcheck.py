"""`jx refcheck` — consistency reports.

Two modes (reference: script/refcheck.py is a RIS bibliography checker):
  -i refs.ris   — RIS entry validation (authors/pages/journal fields,
                  duplicate or near-duplicate authors, leftover N1 notes,
                  escaped `\\&`, duplicate titles). Online metadata
                  cross-checks are skipped in zero-egress environments.
  genotype mode — genotype/phenotype overlap + allele consistency.
"""

from __future__ import annotations

import argparse
import re
import unicodedata

import numpy as np

from janusx_tpu_torch.cli import common


def build_parser(prog="jx refcheck") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Input consistency checks")
    p.add_argument("--online", action="store_true",
                   help="also compare each RIS entry against DOI/OpenAlex "
                        "metadata (needs network; entries degrade to a "
                        "'could not resolve' note when offline)")
    p.add_argument("-i", "--input", type=str, default=None,
                   help="RIS bibliography file to validate")
    common.add_genotype_args(p, required=False)
    p.add_argument("-p", "--pheno", type=str, default=None, help="phenotype file")
    p.add_argument("-g2", "--genotype2", type=str, default=None,
                   help="second genotype input (allele consistency check)")
    return p


def _normalize_text(t: str) -> str:
    t = unicodedata.normalize("NFKD", t)
    t = "".join(c for c in t if not unicodedata.combining(c))
    return re.sub(r"[^a-z0-9]+", " ", t.lower()).strip()


def _parse_ris(path: str):
    """-> list of dicts of TAG -> [values] per entry."""
    entries, cur = [], None
    for line in open(path, encoding="utf-8", errors="replace"):
        m = re.match(r"^([A-Z][A-Z0-9])  - ?(.*)$", line.rstrip("\n"))
        if not m:
            continue
        tag, val = m.group(1), m.group(2).strip()
        if tag == "TY":
            cur = {}
            entries.append(cur)
        if cur is not None:
            cur.setdefault(tag, []).append(val)
        if tag == "ER":
            cur = None
    return entries


def _ris_issues(e: dict) -> list:
    """Local structural checks (reference refcheck.py:_local_issues)."""
    issues = []
    authors = e.get("AU", []) + e.get("A1", [])
    if not authors:
        issues.append("missing authors")
    if any(a.strip().lower() == "others" for a in authors):
        issues.append("contains literal `others` author")
    if (any(a.strip() in {"Manuscript Writing Group", "UK Biobank", "FinnGen"}
            for a in authors) and len(authors) <= 2):
        issues.append("group author only; likely incomplete author list")
    if "SP" not in e:
        issues.append("missing page/article number")
    if "N1" in e:
        issues.append("contains leftover note/encoding field `N1`")
    if any("\\&" in v for v in e.get("T2", [])):
        issues.append("journal contains escaped `\\&`")
    seen = set()
    for a in authors:
        k = _normalize_text(a)
        if k in seen:
            issues.append(f"duplicate/near-duplicate author `{a}`")
            break
        seen.add(k)
    doi = (e.get("DO") or [""])[0]
    if doi and not re.match(r"^(https?://doi\.org/)?10\.\d{4,9}/\S+$", doi):
        issues.append(f"malformed DOI `{doi}`")
    return issues


def _fetch_openalex(entry: dict) -> dict | None:
    """DOI-first OpenAlex lookup (reference refcheck.py:98-129); any
    network/parse failure -> None."""
    import json
    import urllib.parse
    import urllib.request

    def get(url):
        req = urllib.request.Request(url, headers={"User-Agent": "jx-refcheck"})
        with urllib.request.urlopen(req, timeout=8) as resp:
            return json.loads(resp.read().decode("utf-8", "replace"))

    try:
        doi = (entry.get("DO") or entry.get("DOI") or [""])[0].strip()
        if doi:
            doi = doi.removeprefix("https://doi.org/").removeprefix(
                "http://doi.org/")
            return get("https://api.openalex.org/works/https://doi.org/"
                       + urllib.parse.quote(doi, safe=""))
        title = (entry.get("TI") or entry.get("T1") or [""])[0].strip()
        if not title:
            return None
        payload = get("https://api.openalex.org/works?search="
                      + urllib.parse.quote(title) + "&per-page=5")
        results = payload.get("results") or []
        want = _normalize_text(title)
        for rec in results:
            if _normalize_text(rec.get("display_name") or "") == want:
                return rec
        return results[0] if results else None
    except Exception:
        return None


def _online_issues(entry: dict, record: dict | None) -> list:
    """Year/journal/author-count drift vs external metadata (reference
    _online_issues, refcheck.py:171-198 — the core checks)."""
    if record is None:
        return ["could not resolve external metadata"]
    issues = []
    year = (entry.get("PY") or entry.get("Y1") or [""])[0].split("/")[0].strip()
    ext_year = str(record.get("publication_year") or "")
    if year and ext_year and year != ext_year:
        issues.append(f"year differs: RIS `{year}` vs external `{ext_year}`")
    journal = (entry.get("JO") or entry.get("T2") or entry.get("JF")
               or [""])[0]
    ext_journal = (((record.get("primary_location") or {}).get("source")
                    or {}).get("display_name") or "")
    if journal and ext_journal and (_normalize_text(journal)
                                    != _normalize_text(ext_journal)):
        issues.append(f"journal differs: RIS `{journal}` vs external "
                      f"`{ext_journal}`")
    ris_authors = entry.get("AU") or entry.get("A1") or []
    ext_authors = [(a.get("author") or {}).get("display_name", "")
                   for a in (record.get("authorships") or [])]
    if ris_authors and ext_authors and len(ris_authors) < len(ext_authors) \
            and len(ris_authors) <= 2:
        issues.append(f"author list appears truncated: RIS "
                      f"{len(ris_authors)} vs external {len(ext_authors)}")
    return issues


def _run_ris(path: str, online: bool = False) -> int:
    entries = _parse_ris(path)
    if not entries:
        print(f"no RIS entries found in {path}")
        return 1
    n_bad = 0
    titles = {}
    for i, e in enumerate(entries, 1):
        title = (e.get("TI") or e.get("T1") or ["<untitled>"])[0]
        issues = _ris_issues(e)
        if online:
            issues.extend(_online_issues(e, _fetch_openalex(e)))
        key = _normalize_text(title)
        if key in titles:
            issues.append(f"duplicate title of entry #{titles[key]}")
        else:
            titles[key] = i
        if issues:
            n_bad += 1
            print(f"#{i}\t{title[:70]}")
            for msg in issues:
                print(f"\t- {msg}")
    tail = "" if online else "\t(offline checks only; --online adds " \
        "DOI/OpenAlex cross-checks)"
    print(f"checked {len(entries)} entries\tissues in {n_bad}{tail}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.input:
        return _run_ris(args.input, online=args.online)
    if not any((args.bfile, args.vcf, args.hmp, args.file)):
        raise SystemExit("either -i refs.ris or a genotype input is required")
    from janusx_tpu_torch.io.gfreader import load_raw_packed

    raw = load_raw_packed(common.resolve_genotype(args))
    print(f"genotype\t{raw.m} SNPs x {raw.n_samples} samples")
    dup = len(raw.samples) - len(set(map(str, raw.samples)))
    if dup:
        print(f"WARNING\t{dup} duplicated sample IDs")
    keys = list(zip(map(str, raw.sites.chrom), raw.sites.pos.tolist()))
    dup_sites = len(keys) - len(set(keys))
    if dup_sites:
        print(f"WARNING\t{dup_sites} duplicated (chrom,pos) sites")

    if args.pheno:
        from janusx_tpu_torch.io.pheno import load_phenotype

        ph = load_phenotype(args.pheno)
        gset = set(map(str, raw.samples))
        pset = set(map(str, ph.samples))
        inter = gset & pset
        print(
            f"phenotype\t{len(ph.samples)} samples, {len(ph.traits)} traits;"
            f" matched={len(inter)} geno-only={len(gset - pset)}"
            f" pheno-only={len(pset - gset)}"
        )
        for t_i, trait in enumerate(ph.traits):
            v = ph.values[:, t_i]
            print(
                f"trait\t{trait}\tn={np.isfinite(v).sum()}"
                f"\tmean={np.nanmean(v):.4g}\tsd={np.nanstd(v):.4g}"
            )
    if args.genotype2:
        raw2 = load_raw_packed(args.genotype2)
        k1 = {(str(c), int(p)): i for i, (c, p) in enumerate(zip(raw.sites.chrom, raw.sites.pos))}
        k2 = {(str(c), int(p)): i for i, (c, p) in enumerate(zip(raw2.sites.chrom, raw2.sites.pos))}
        shared = set(k1) & set(k2)
        same = swapped = mismatch = 0
        for key in shared:
            i, j = k1[key], k2[key]
            a = (str(raw.sites.allele0[i]), str(raw.sites.allele1[i]))
            b = (str(raw2.sites.allele0[j]), str(raw2.sites.allele1[j]))
            if a == b:
                same += 1
            elif a == (b[1], b[0]):
                swapped += 1
            else:
                mismatch += 1
        print(
            f"genotype2\t{raw2.m} SNPs; shared={len(shared)}"
            f" same-allele={same} swapped={swapped} mismatched={mismatch}"
        )
    return 0
