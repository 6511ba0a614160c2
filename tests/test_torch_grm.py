"""Port parity: janusx_tpu_torch.models.grm vs janusx_tpu.models.grm.

Methods 1 (centered), 2 (standardized) and 3 (dominance), with block
sizes that cross the 16-block f32 -> f64 flush boundary. Bound: rtol 1e-6
with an absolute floor of 1e-6 x max|K| — both sides sum f32 block
products in their own order, and that rounding is relative to the matrix
scale, not to an off-diagonal entry that happens to be ~0.
"""

import numpy as np
import pytest

from janusx_tpu.io.gdata import GenotypeData as JGenotypeData, SiteInfo as JSiteInfo
from janusx_tpu.io.packed import QcParams as JQc, pack_genotypes as j_pack
from janusx_tpu.models.grm import grm_from_packed as j_grm
from janusx_tpu_torch.io.gdata import GenotypeData as TGenotypeData, SiteInfo as TSiteInfo
from janusx_tpu_torch.io.packed import QcParams as TQc, pack_genotypes as t_pack
from janusx_tpu_torch.models.grm import grm_from_packed as t_grm


def _panel(m, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    g[rng.random((m, n)) < 0.02] = -1
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"i{j}" for j in range(n)], object)
    pj = j_pack(JGenotypeData(g, JSiteInfo(**site), samples), JQc(maf=0.02, geno=0.05))
    pt = t_pack(TGenotypeData(g, TSiteInfo(**site), samples), TQc(maf=0.02, geno=0.05))
    np.testing.assert_array_equal(pt.packed, pj.packed)
    return pj, pt


@pytest.mark.parametrize("method,m,n,block", [
    (1, 600, 150, 128),   # 5 blocks, one flush
    (1, 700, 101, 16),    # 44 blocks: three flush superblocks, ragged n
    (2, 700, 101, 16),
    (3, 500, 90, 16),     # 32 blocks: exactly two full flush superblocks
])
def test_grm_matches_reference(method, m, n, block):
    pj, pt = _panel(m, n, seed=method * 1000 + m)
    Kj = j_grm(pj, method=method, block=block)
    Kt = t_grm(pt, method=method, block=block, device="cpu")
    assert Kt.dtype == np.float64 and Kt.shape == (pt.n_samples,) * 2
    np.testing.assert_allclose(Kt, Kj, rtol=1e-6, atol=1e-6 * np.abs(Kj).max())
    np.testing.assert_allclose(Kt, Kt.T, rtol=0, atol=1e-12 * np.abs(Kt).max())


def test_grm_cache_shared_between_packages(tmp_path):
    """utils.cache uses the reference's file names: a GRM cached by one
    package is read back by the other."""
    from janusx_tpu.utils.cache import load_or_build_grm as j_cache
    from janusx_tpu_torch.utils.cache import grm_cache_paths, load_or_build_grm as t_cache

    pj, pt = _panel(300, 60, seed=5)
    prefix = str(tmp_path / "panel")
    Kj = j_cache(prefix, pj, 0.02, 0.05)
    npy, ids = grm_cache_paths(prefix, 0.02, 0.05)
    np.save(npy, Kj + 1.0)  # a port rebuild would not reproduce this
    np.testing.assert_array_equal(t_cache(prefix, pt, 0.02, 0.05), Kj + 1.0)
