"""sparse_null_ms: ms per traced trait inside the program's span
``sparse_null``, the sparse null fit (``models.splmm.fit_sparse_null``,
with the per-component spectra of ``BlockSpectralK.from_sparse``)."""

from portbench import program_spans


def read(run):
    return program_spans.span_ms(run, "sparse_null")
