"""device_idle_pct.lowrank: 100 x (1 - the union of the device's operations
(kernels, copies, fills) / the traced window), the window running from the
first step's start to the last step's end."""


def read(run):
    return run.idle_pct()
