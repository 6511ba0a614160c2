"""Analysis models: GRM and the exact LMM scan."""
