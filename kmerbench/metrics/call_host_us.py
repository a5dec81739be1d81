"""call_host_us (us, host clock): host time for one call to return, its
answers enqueued and not awaited (the facade, the index's code
conversion, the kernel wrapper and the launch), as the mean over the
window's calls: the sum of their submission times over their number."""


def read(run):
    if not run.calls:
        return None
    return run.submit_s / run.calls * 1e6
