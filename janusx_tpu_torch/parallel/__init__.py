"""Multi-device scaling: the SNP mesh, its shards, multi-process runs."""
