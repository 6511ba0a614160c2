"""Shared infrastructure: TSV writers, progress, caching, prefetch."""
