"""null_fit_launches: kernel launches the host issued inside the program's
span ``fit_null`` (host events ``cudaLaunchKernel*`` / ``cuLaunchKernel*``),
per traced trait."""

from portbench import program_spans


def read(run):
    return program_spans.launches_in(run, "fit_null")
