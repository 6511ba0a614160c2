"""gamma_ms: ms per traced trait inside the program's span ``gamma``, the
GRAMMAR-gamma calibration on sampled null markers
(``models.splmm._calibrate_gamma``)."""

from portbench import program_spans


def read(run):
    return program_spans.span_ms(run, "gamma")
