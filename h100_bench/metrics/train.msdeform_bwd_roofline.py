"""Share of its roofline of the deformable sampler's backward, the port's
``ops/msdeform.py::_launch_bwd`` (kernel K2): 100 x the summed bound of its
calls in the traced window (``counts/ops.py``, from each call's arguments)
over the device time of the kernels launched inside the harness's span
``h100_bench::msdeform_bwd`` around the calls."""


def read(trace):
    return trace.roofline("msdeform_bwd")
