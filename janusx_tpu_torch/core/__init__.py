"""Statistical core: spectral decomposition, REML/ML objectives, tests."""
