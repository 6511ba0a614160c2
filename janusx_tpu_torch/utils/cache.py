"""Analysis artifact caches (GRM / PCA), reference naming contract.

Reference behavior (SURVEY cache contract; workflow.py:3123 GRM cache,
:243-316 PCA cache, gfreader.py:348 cache dir control):

- GRM cache: ``{geno_prefix}.maf{maf}.geno{geno}.cGRM.npy`` (method 1) or
  ``...sGRM.npy`` (method 2), plus a ``.id`` sidecar with sample IDs; the
  cache is only valid when the ID list matches.
- When the genotype directory is not writable, fall back to
  ``$JANUSX_CACHE_DIR`` (or the system temp dir).
- Writes are atomic (tmp + rename).
"""

from __future__ import annotations

import logging
import os
import tempfile

import numpy as np

from janusx_tpu_torch import config

log = logging.getLogger("janusx_tpu.cache")


def _fmt_qc(v: float) -> str:
    s = f"{v:g}"
    return s


def _dir_writable(d: str) -> bool:
    # os.access is bypassed by root (returns True even for r-x dirs), so
    # check the permission bits too: a directory with no write bit set is
    # treated as read-only regardless of euid (matches the reference's
    # read-only-genotype-dir fallback intent, gfreader.py:348).
    if not os.access(d, os.W_OK):
        return False
    try:
        return bool(os.stat(d).st_mode & 0o222)
    except OSError:
        return False


def cache_dir_for(path_prefix: str) -> str:
    d = os.path.dirname(os.path.abspath(path_prefix)) or "."
    if _dir_writable(d):
        return d
    override = config.cache_dir_override()
    if override:
        os.makedirs(override, exist_ok=True)
        return override
    fallback = os.path.join(tempfile.gettempdir(), "janusx_tpu_cache")
    os.makedirs(fallback, exist_ok=True)
    return fallback


def _read_id_column(path: str) -> list:
    with open(path) as fh:
        return [l.split()[0] for l in fh if l.strip()]


def grm_cache_paths(geno_prefix: str, maf: float, geno: float, method: int = 1):
    tag = "cGRM" if method != 2 else "sGRM"
    base = os.path.basename(geno_prefix)
    d = cache_dir_for(geno_prefix)
    stem = os.path.join(d, f"{base}.maf{_fmt_qc(maf)}.geno{_fmt_qc(geno)}.{tag}")
    return stem + ".npy", stem + ".id"


def atomic_save_npy(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


def sparse_grm_cache_paths(
    geno_prefix: str, maf: float, geno: float, cutoff: float, method: int = 1
):
    """`.jxgrm` + `.id` cache paths (reference `_ensure_splmm_sparse_grm`
    cache, workflow_model_packed.py:807; file format spgrm.rs)."""
    base = os.path.basename(geno_prefix)
    d = cache_dir_for(geno_prefix)
    tag = "cGRM" if method != 2 else "sGRM"
    stem = os.path.join(
        d,
        f"{base}.maf{_fmt_qc(maf)}.geno{_fmt_qc(geno)}"
        f".cut{_fmt_qc(cutoff)}.sp{tag}",
    )
    return stem + ".jxgrm", stem + ".id"


def load_or_build_sparse_grm(
    geno_prefix: str,
    pg,
    maf: float,
    geno: float,
    cutoff: float,
    method: int = 1,
    block: int | None = None,
    use_cache: bool = True,
):
    """Thresholded sparse GRM with a `.jxgrm`+`.id` cache — the dense n²
    matrix is never formed (band-streamed builder, models.splmm)."""
    from janusx_tpu_torch import config as _cfg
    from janusx_tpu_torch.io.jxgrm import read_jxgrm, write_jxgrm
    from janusx_tpu_torch.models.splmm import build_sparse_grm

    jxgrm_path, id_path = sparse_grm_cache_paths(
        geno_prefix, maf, geno, cutoff, method
    )
    ids = [str(s) for s in pg.samples]
    if use_cache and os.path.exists(jxgrm_path) and os.path.exists(id_path):
        cached_ids = _read_id_column(id_path)
        if cached_ids == ids:
            try:
                K = read_jxgrm(jxgrm_path)
                if K.shape == (len(ids), len(ids)):
                    log.info("sparse GRM cache hit: %s", jxgrm_path)
                    return K
                log.info("sparse GRM cache stale (shape mismatch): %s", jxgrm_path)
            except Exception as e:
                log.warning("sparse GRM cache unreadable (%s): %s", e, jxgrm_path)
        else:
            log.info("sparse GRM cache stale (ids changed): %s", jxgrm_path)
    K = build_sparse_grm(
        pg, cutoff=cutoff, method=method, block=block or _cfg.DEFAULT_SNP_BLOCK
    )
    if use_cache:
        try:
            write_jxgrm(jxgrm_path, K)
            tmp = id_path + ".tmp"
            with open(tmp, "wt") as fh:
                fh.write("\n".join(ids) + "\n")
            os.replace(tmp, id_path)
            log.info("sparse GRM cached: %s", jxgrm_path)
        except OSError as e:
            log.warning("sparse GRM cache write failed: %s", e)
    return K.tocsc()


def load_or_build_grm(
    geno_prefix: str,
    pg,
    maf: float,
    geno: float,
    method: int = 1,
    block: int | None = None,
    use_cache: bool = True,
    mesh=None,
) -> np.ndarray:
    """GRM with reference-style npy+id cache keyed by sample IDs."""
    from janusx_tpu_torch import config as _cfg
    from janusx_tpu_torch.models.grm import grm_from_packed

    npy_path, id_path = grm_cache_paths(geno_prefix, maf, geno, method)
    ids = [str(s) for s in pg.samples]
    if use_cache and os.path.exists(npy_path) and os.path.exists(id_path):
        cached_ids = _read_id_column(id_path)
        if cached_ids == ids:
            try:
                K = np.load(npy_path)
                if K.shape == (len(ids), len(ids)):
                    log.info("GRM cache hit: %s", npy_path)
                    return K
                log.info("GRM cache stale (shape mismatch): %s", npy_path)
            except Exception as e:
                log.warning("GRM cache unreadable (%s): %s", e, npy_path)
        else:
            log.info("GRM cache stale (ids changed): %s", npy_path)
    K = grm_from_packed(
        pg, method=method, block=block or _cfg.DEFAULT_SNP_BLOCK, mesh=mesh
    )
    if use_cache:
        try:
            atomic_save_npy(npy_path, K)
            tmp = id_path + ".tmp"
            with open(tmp, "wt") as fh:
                fh.write("\n".join(ids) + "\n")
            os.replace(tmp, id_path)
            log.info("GRM cached: %s", npy_path)
        except OSError as e:
            log.warning("GRM cache write failed: %s", e)
    return K


def pc_cache_path(geno_prefix: str, maf: float, geno: float, n_pcs: int,
                  method: int = 1) -> str:
    """Reference PCA-Q cache naming: {...}.cGRM.pc{q}.txt
    (workflow.py:243-316 load_or_build_q_with_cache)."""
    npy_path, _ = grm_cache_paths(geno_prefix, maf, geno, method)
    return npy_path[: -len(".npy")] + f".pc{int(n_pcs)}.txt"


def load_or_build_pcs(
    geno_prefix: str,
    K: np.ndarray,
    samples,
    maf: float,
    geno: float,
    n_pcs: int,
    method: int = 1,
    use_cache: bool = True,
) -> np.ndarray:
    """Leading GRM eigenvector covariates with the reference text cache
    (sample-ID column + q PC columns; cache keyed by the ID column)."""
    path = pc_cache_path(geno_prefix, maf, geno, n_pcs, method)
    ids = [str(s) for s in samples]
    if use_cache and os.path.exists(path):
        try:
            with open(path) as fh:
                rows = [l.rstrip("\n").split("\t") for l in fh if l.strip()]
            if [r[0] for r in rows] == ids and all(
                len(r) == n_pcs + 1 for r in rows
            ):
                log.info("PCA-Q cache hit: %s", path)
                return np.array([[float(v) for v in r[1:]] for r in rows])
        except Exception:
            pass
        log.info("PCA-Q cache stale: %s", path)
    from janusx_tpu_torch.core.spectral import eigh_grm

    basis = eigh_grm(np.asarray(K), diag_ridge=0.0)
    pcs = basis.U[:, -n_pcs:][:, ::-1].copy()  # leading PCs first
    if use_cache:
        try:
            tmp = path + ".tmp"
            with open(tmp, "wt") as fh:
                for sid, row in zip(ids, pcs):
                    fh.write(sid + "\t" + "\t".join(f"{v:.8g}" for v in row)
                             + "\n")
            os.replace(tmp, path)
            log.info("PCA-Q cached: %s", path)
        except OSError:
            pass
    return pcs
