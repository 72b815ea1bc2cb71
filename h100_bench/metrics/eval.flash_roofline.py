"""Share of its roofline of Phi's causal attention,
``ops/flash_attention.py::flash_attention`` as ``models/phi.py`` calls it:
100 x the summed bound of its calls in the traced window
(``counts/ops.py``, from each call's arguments) over the device time of the
kernels launched inside the harness's span ``h100_bench::flash`` around the
calls."""


def read(trace):
    return trace.roofline("flash")
