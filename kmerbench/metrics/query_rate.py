"""query_rate (kmers/s, host clock): every code answered in the window
over the window's seconds, from the first submission to the last call's
answers complete."""


def read(run):
    if run.window_s <= 0 or not run.codes_answered:
        return None
    return run.codes_answered / run.window_s
