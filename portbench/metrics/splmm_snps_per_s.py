"""splmm_snps_per_s: SNP x trait tests of the GRAMMAR scan completed in
the window / the window's seconds (the window ends when its last step
ends)."""


def read(run):
    return run.tests_per_s()
