"""setup_s: seconds from the process's start to the first timed unit's due
time (loading, the build of the operator and of the kernels, warm-up)."""


def read(run):
    return run.setup_s
