"""`jx view` — inspect binary artifacts (reference: script/view.py)."""

from __future__ import annotations

import argparse

import numpy as np


def build_parser(prog="jx view") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Dump genotype/matrix artifacts")
    p.add_argument("input", type=str, help=".bed prefix / .npy / .npz / genotype file")
    p.add_argument("-head", "--head", type=int, default=5, help="rows to preview")
    p.add_argument("-bin", "--bin", action="store_true",
                   help="treat the input as a BIN01 matrix regardless of "
                        "extension (reference -bin)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    path = args.input
    as_bin = args.bin or path.endswith(".bin")
    if not as_bin and path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        print(f"npy\t{arr.shape}\t{arr.dtype}")
        print(np.array2string(np.asarray(arr[: args.head, : min(8, arr.shape[-1])] if arr.ndim == 2 else arr[: args.head]), precision=4))
        return 0
    if not as_bin and path.endswith(".npz"):
        z = np.load(path)
        for k in z.files:
            print(f"{k}\t{z[k].shape}\t{z[k].dtype}")
        return 0
    if not as_bin and (path.endswith(".jxgrm") or path.endswith(".spgrm")):
        from janusx_tpu_torch.io.jxgrm import jxgrm_n_samples, read_jxgrm

        n = jxgrm_n_samples(path)
        K = read_jxgrm(path).tocsr()
        nnz = K.nnz
        print(f"jxgrm\tn={n}\tnnz={nnz}\tdensity={nnz / max(1, n * n):.4g}")
        head = min(args.head, n)
        for i in range(head):
            row = K.getrow(i)
            ent = "  ".join(
                f"{j}:{v:.4g}" for j, v in zip(row.indices[:6], row.data[:6]))
            print(f"{i}\t{ent}{' ...' if row.nnz > 6 else ''}")
        return 0
    if as_bin:
        from janusx_tpu_torch.io import bin01

        bm = bin01.read_bin01(path)
        sites = bm.sites()
        print(f"BIN01\trows={bm.n_rows}\tsamples={bm.n_samples}")
        head = min(args.head, bm.n_rows)
        dense = bm.dense(0, head)
        for i in range(head):
            label = ""
            if sites is not None and i < len(sites):
                s = sites[i]
                label = s if isinstance(s, str) else "\t".join(map(str, s))
            bits = "".join(map(str, dense[i, : min(40, bm.n_samples)]))
            print(f"{i}\t{label}\t{bits}{'...' if bm.n_samples > 40 else ''}")
        return 0
    from janusx_tpu_torch.io.gfreader import detect_format, inspect_genotype_file, load_raw_packed

    fmt, p = detect_format(path)
    info = inspect_genotype_file(path)
    print(f"format={fmt}\tsamples={info.n_samples}\tsnps={info.n_snps}")
    raw = load_raw_packed(path)
    from janusx_tpu_torch.io import bitcodec

    head = min(args.head, raw.m)
    # read_window_codes works for RawPacked and low-memory WindowedBed alike
    codes = bitcodec.unpack_codes(raw.read_window_codes(0, head), raw.n_samples)
    geno = codes.astype(np.int8)
    geno[codes == 3] = -1
    for i in range(head):
        s = raw.sites
        row = " ".join(str(v) for v in geno[i, : min(12, raw.n_samples)])
        print(f"{s.chrom[i]}\t{s.pos[i]}\t{s.snp[i]}\t{s.allele0[i]}/{s.allele1[i]}\t{row} ...")
    return 0
