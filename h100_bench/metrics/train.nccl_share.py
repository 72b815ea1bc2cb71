"""Share of rank 0's traced training window that NCCL kernels ran on its card,
in %: the gradient all-reduce and the moment slices' all-gather, transfer
and the wait for the slowest rank together."""


def read(trace):
    if trace.chips < 2 or trace.window_s <= 0:
        return None
    nccl = trace.kernel_s(lambda name: "nccl" in name.lower())
    return 100.0 * nccl / trace.window_s
