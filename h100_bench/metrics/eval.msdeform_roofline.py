"""Share of its roofline of the deformable sampler's forward, the port's
``ops/msdeform.py::ms_deform_attn``: 100 x the summed bound of its calls in
the traced window (``counts/ops.py``, from each call's arguments) over the
device time of the kernels launched inside the harness's span
``h100_bench::msdeform`` around the calls."""


def read(trace):
    return trace.roofline("msdeform")
