"""gtools — annotation readers, region queries, WGCNA helpers.

Reference: JanusX python/janusx/gtools/ (reader.py gffreader/
bedreader/GFFQuery, wgcna.py cor/adj/tom/cluster).

The annotation readers import pandas, so they load on first use: the
WGCNA helpers import without it."""

from janusx_tpu_torch.gtools.wgcna import (adj, cluster, cor, pick_soft_threshold,
                                           tom, write_modules_tsv)

__all__ = [
    "GFFQuery", "bedreader", "gffreader",
    "cor", "adj", "tom", "cluster", "pick_soft_threshold",
]

_READERS = ("GFFQuery", "bedreader", "gffreader")


def __getattr__(name):
    if name in _READERS:
        from janusx_tpu_torch.gtools import reader

        return getattr(reader, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
