"""setup_s: seconds from the start of the process to the first timed step
(data, the program's set-up, warm-up; the first run in a checkout also
builds the kernels)."""


def read(run):
    return run.setup_s
