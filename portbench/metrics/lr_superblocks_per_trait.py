"""lr_superblocks_per_trait: the low-rank scan's resident superblocks per
traced trait, as the program counts them (``lowrank.superblocks``) while
the profiler recorded; each is one K1 launch and one copy back."""

from portbench import program_spans


def read(run):
    return program_spans.counted(run, "lowrank.superblocks")
