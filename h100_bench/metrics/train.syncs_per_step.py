"""Runtime calls after which the host waits for the card (stream, device and
event synchronizations, synchronous copies) in the profiler's CPU trace of
rank 0's training window, per step."""


def read(trace):
    steps = trace.work.get("steps")
    if not steps:
        return None
    return trace.syncs() / steps
