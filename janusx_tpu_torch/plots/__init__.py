"""Plotting toolkit (reference: python/janusx/bioplotkit/)."""
