"""host_p_ms: ms per traced trait inside the program's span ``host_p``:
the GRAMMAR scan's beta, se and p-values on the host from the grams the
card returned."""

from portbench import program_spans


def read(run):
    return program_spans.span_ms(run, "host_p")
