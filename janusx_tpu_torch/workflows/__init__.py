"""End-to-end analysis workflows (GWAS -lmm)."""
