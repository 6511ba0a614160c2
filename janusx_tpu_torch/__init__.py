"""janusx_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of janusx_tpu.

A second package beside the JAX reference: the same CLI surface, QC rules,
statistics and TSV output, with each Pallas kernel on the ported path, and
each sweep of the Bayes samplers, written by hand as a CUDA C++ kernel for
sm_90a (csrc/). It imports torch, numpy and scipy, never jax. Ported:
every ``jx gwas`` route, on one card or SNP-sharded over several
(``parallel``; ``jx grm --distributed`` over several processes), ``jx gs``
(BLUP, GBLUP, rrBLUP exact and PCG, GBLUPd/ad, the HE pre-fit, ``-hash``,
the TOP bundle, effect and model export, BayesA/B/Cπ) with ``jx
gspredict``, ``jx grm``, ``jx pca``, ``jx gstats`` (site/sample tables, LD
scores, KING), ``jx fvlmm2 -i``, ``jx fastpop``, ``jx tree``, ``jx
garfield`` (the logic-rule search, B and its scores on the device) with
``jx postgarfield``, ``jx benchmark`` with ``jx gblupbench``, ``jx
bayesbench`` and ``jx garfieldbench``, the genotype tools and validation
CLIs (``jx sim``, ``jx gformat``, ``jx gmerge``, ``jx view``, ``jx
refcheck``, ``jx hybrid``, ``jx reml``, ``jx postgwas``, ``jx postgs``,
``jx treeplot``, ``jx env``, ``jx ggval``), the WGCNA helpers (``gtools``)
and the in-memory API (``api.ASSOC``, ``api.GenomicSelection``): every
module of janusx_tpu. ROADMAP.md lists the work that remains.
"""

__version__ = "0.1.0"
