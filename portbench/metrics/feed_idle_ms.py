"""feed_idle_ms: ms per traced trait in which the card sat idle while the
program waited for the next chunk of the panel on the host (span ``feed``)
or padded and copied it to the card (span ``upload``): each idle stretch
inside a step, cut at the program's spans, goes to the innermost one."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms(run, ("feed", "upload"))
