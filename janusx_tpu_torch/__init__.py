"""janusx_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of janusx_tpu.

A second package beside the JAX reference: the same CLI surface, QC rules,
statistics and TSV output, with each Pallas kernel on the ported path
rewritten as a hand-written CUDA C++ kernel for sm_90a (csrc/). It imports
torch, numpy and scipy, never jax. Ported so far: ``jx gwas -lmm`` (grid
method, single trait); see ROADMAP.md for what remains.
"""

__version__ = "0.1.0"
