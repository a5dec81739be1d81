"""setup_s (s, host clock): from the process's start to the window's
start: imports, the device's context, the corpus and the pool from the
seed, the port's build of the index, and the warm-up of every batch."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
