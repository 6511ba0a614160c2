"""h2d_mb_per_trait: MB (10^6 bytes) copied from the host to the card per
traced trait, as the program counts them (``h2d_bytes``: every upload of
its device cache on a miss, the per-call operands of the LM grams and a
trait's rotated data) while the profiler recorded."""

from portbench import program_spans


def read(run):
    n = program_spans.counted(run, "h2d_bytes")
    return None if n is None else n * 1e-6
