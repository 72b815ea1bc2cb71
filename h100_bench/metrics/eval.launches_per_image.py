"""Runtime calls that put work on the card (kernel launches, async copies and
fills, graph launches) in the profiler's CPU trace of the eval window, per
image."""


def read(trace):
    images = trace.work.get("images")
    if not images:
        return None
    return trace.launches() / images
