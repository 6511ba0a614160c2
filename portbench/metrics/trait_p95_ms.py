"""trait_p95_ms: the 95th percentile (linear interpolation) of the wall
time of every trait of the window, from its phenotype handed to the
program to its p-values on the host; a trait of a step of T traits takes
the step's time."""

import numpy as np


def read(run):
    times = [s.t1 - s.t0 for s in run.steps for _ in range(s.traits) if s.tests]
    return 1e3 * float(np.percentile(times, 95)) if times else None
