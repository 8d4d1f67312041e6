"""setup_s: from the process's start to the first timed job: torch and the
card, the program's scene and tables, any build of its kernels, and the
warm-up job."""


def read(run):
    return run.setup_s
