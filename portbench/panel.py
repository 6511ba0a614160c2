"""Synthetic genotype panels, made on the device from the seed.

A panel is drawn in chunks of ``CHUNK`` SNPs with one ``torch.Generator``
on the card, so a seed gives the same panel on every run. Samples come in
sibships: ``family_size`` children of two unrelated parents, each child
drawing one paternal and one maternal haplotype per ``segment_snps`` SNPs
(one recombination point per segment), so the GRM carries relatedness as
in a real panel and the null REML has an interior optimum. Per SNP the
allele frequency is U[maf_range] and each genotype is missing with
probability ``missing_rate``.

From the raw codes the same pass makes, on the card:

- ``raw``: the 2-bit codes of every genotyped sample, as drawn (dosage of
  the drawn allele, 3 = missing, sample j in bits 2*(j % 4) of byte j//4);
  the plain reference starts from these;
- per requested sample set, the program's input: the SNPs that pass the
  configuration's QC on that set, flipped so the minor allele is counted,
  with their allele frequency, missing rate and mean dosage (the fields
  of ``janusx_tpu_torch.io.packed.PackedGenotypes``);
- ``scores``: ``background_scores`` polygenic scores of the phenotyped
  samples, Z^T R / sqrt(m) for standardized genotypes Z and a Gaussian R,
  from which the traffic draws each trait's polygenic background.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CHUNK = 32_000  # SNPs per draw; fixed, so the draws do not depend on memory
MISSING = 3


def sub_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed and a key."""
    ss = np.random.SeedSequence([seed % (1 << 64), *key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def pack(codes: torch.Tensor) -> torch.Tensor:
    """(k, n) uint8 codes -> (k, ceil(n/4)) bytes, tail padded with code 3."""
    k, n = codes.shape
    nb = -(-n // 4)
    if nb * 4 != n:
        pad = torch.full((k, nb * 4 - n), MISSING, dtype=torch.uint8, device=codes.device)
        codes = torch.cat([codes, pad], dim=1)
    q = codes.reshape(k, nb, 4)
    return q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)


def unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(k, nb) bytes -> (k, n) uint8 codes."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    return ((packed.unsqueeze(-1) >> shifts) & 3).reshape(packed.shape[0], -1)[:, :n]


def allele_stats(codes: torch.Tensor):
    """Per-row (non-missing count, alt frequency over non-missing) in f64."""
    obs = codes != MISSING
    nm = obs.sum(dim=1)
    alt = torch.where(obs, codes, torch.zeros_like(codes)).sum(dim=1, dtype=torch.int64)
    af = alt.double() / torch.clamp(2.0 * nm.double(), min=1.0)
    return nm, af


def qc_flip(codes: torch.Tensor, qc: dict):
    """The configuration's QC on one sample set (the port's default rule:
    missing rate <= geno, minor allele frequency >= maf, some genotype
    observed) and the minor-allele flip. Returns (keep, flip, af, miss)."""
    n = codes.shape[1]
    nm, af_alt = allele_stats(codes)
    miss = 1.0 - nm.double() / float(n)
    flip = af_alt > 0.5
    af = torch.where(flip, 1.0 - af_alt, af_alt)
    keep = (miss <= qc["geno"]) & (nm > 0) & (torch.minimum(af, 1.0 - af) >= qc["maf"])
    return keep, flip & keep, af, miss


@dataclass
class SetCodes:
    """One sample set's program input, on the host."""

    samples: np.ndarray  # sorted sample indices into the panel
    packed: np.ndarray  # (m_kept, ceil(n_set/4)) uint8, minor allele counted
    af: np.ndarray
    miss: np.ndarray
    keep: np.ndarray  # (m,) bool: which panel SNPs passed QC

    @property
    def mean(self) -> np.ndarray:
        return 2.0 * self.af


@dataclass
class Panel:
    raw: np.ndarray  # (m, ceil(n/4)) uint8 raw codes of every genotyped sample
    n: int
    phenotyped: np.ndarray  # sorted indices of the phenotyped samples
    sets: dict  # name -> SetCodes
    scores: np.ndarray  # (n_phenotyped, background_scores) f64


def phenotyped_samples(cfg: dict, seed: int) -> np.ndarray:
    n, n_ph = cfg["n_samples"], cfg["n_phenotyped"]
    if n_ph == n:
        return np.arange(n)
    rng = np.random.default_rng(sub_seed(seed, 1))
    return np.sort(rng.choice(n, n_ph, replace=False))


def generate(cfg: dict, seed: int, device, sets: dict, n_scores: int) -> Panel:
    """Draw the panel of configuration ``cfg`` on ``device``; ``sets`` maps
    a name to the sample indices whose program input is wanted ("all" and
    "phenotyped" are understood)."""
    n, m = cfg["n_samples"], cfg["n_snps"]
    fam, seg = cfg["family_size"], cfg["segment_snps"]
    lo, hi = cfg["maf_range"]
    if CHUNK % seg:
        raise ValueError(f"segment_snps {seg} must divide {CHUNK}")
    ph = phenotyped_samples(cfg, seed)
    index = {"all": np.arange(n), "phenotyped": ph}
    sets = {k: index.get(v, v) if isinstance(v, str) else np.asarray(v) for k, v in sets.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 2))
    dev = torch.device(device)
    n_fam = -(-n // fam)
    fam_of = torch.arange(n, device=dev) // fam
    ph_d = torch.as_tensor(ph, device=dev)
    set_d = {k: torch.as_tensor(v, device=dev) for k, v in sets.items()}
    raw = np.empty((m, -(-n // 4)), np.uint8)
    parts = {k: [] for k in sets}
    scores = torch.zeros((len(ph), n_scores), dtype=torch.float64, device=dev)
    for s0 in range(0, m, CHUNK):
        k = min(CHUNK, m - s0)
        p = lo + (hi - lo) * torch.rand(k, generator=gen, device=dev)
        haps = (torch.rand((k, 4 * n_fam), generator=gen, device=dev) < p[:, None]).to(torch.uint8)
        n_seg = -(-k // seg)
        pat = 4 * fam_of + torch.randint(0, 2, (n_seg, n), generator=gen, device=dev)
        mat = 4 * fam_of + 2 + torch.randint(0, 2, (n_seg, n), generator=gen, device=dev)
        g = torch.empty((k, n), dtype=torch.uint8, device=dev)
        for j in range(n_seg):
            r0, r1 = j * seg, min((j + 1) * seg, k)
            g[r0:r1] = haps[r0:r1, pat[j]] + haps[r0:r1, mat[j]]
        del haps
        miss = torch.rand((k, n), generator=gen, device=dev) < cfg["missing_rate"]
        codes = torch.where(miss, torch.full_like(g, MISSING), g)
        del g, miss
        raw[s0:s0 + k] = pack(codes).cpu().numpy()
        for name, idx in set_d.items():
            c = codes[:, idx]
            keep, flip, af, mr = qc_flip(c, cfg["qc"])
            c = torch.where(flip[:, None] & (c != MISSING), 2 - c, c)[keep]
            parts[name].append((pack(c).cpu(), af[keep].cpu(), mr[keep].cpu(), keep.cpu()))
        c = codes[:, ph_d]
        nm, af_alt = allele_stats(c)
        sd = torch.sqrt(2.0 * af_alt * (1.0 - af_alt))
        z = (c.double() - 2.0 * af_alt[:, None]) / torch.where(sd > 0, sd, 1.0)[:, None]
        z = torch.where(c == MISSING, 0.0, z)
        R = torch.randn((k, n_scores), generator=gen, device=dev, dtype=torch.float64)
        scores += z.T @ R
        del codes, c, z
    out = {}
    for name, ps in parts.items():
        pk, af, mr, keep = (torch.cat(x).numpy() for x in zip(*ps))
        out[name] = SetCodes(samples=sets[name], packed=pk, af=af, miss=mr, keep=keep)
    scores = (scores / np.sqrt(m)).cpu().numpy()
    if dev.type == "cuda":
        # the drawing's buffers are the benchmark's: the run's memory peak
        # is the program's from here on
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return Panel(raw=raw, n=n, phenotyped=ph, sets=out, scores=scores)


def program_input(panel: Panel, name: str):
    """The set's codes as the port's ``PackedGenotypes`` (sites are
    placeholders: the scans carry them through untouched)."""
    from janusx_tpu_torch.io.gdata import SiteInfo
    from janusx_tpu_torch.io.packed import PackedGenotypes

    s = panel.sets[name]
    m = s.packed.shape[0]
    pos = np.nonzero(s.keep)[0].astype(np.int64)
    sites = SiteInfo(chrom=np.full(m, "1", object), pos=pos + 1,
                     snp=pos.astype(object), allele0=np.full(m, "A", object),
                     allele1=np.full(m, "G", object))
    return PackedGenotypes(packed=s.packed, n_samples=len(s.samples), sites=sites,
                           samples=np.array([f"s{j}" for j in s.samples], object),
                           af=s.af, miss=s.miss, mean=s.mean)
