"""Share of its roofline of the Swin window-attention core,
``ops/swin_attention.py::window_attention`` as ``models/swin.py`` calls it:
100 x the summed bound of its calls in the traced window
(``counts/ops.py``, from each call's arguments) over the device time of the
kernels launched inside the harness's span ``h100_bench::swin_attn`` around
the calls."""


def read(trace):
    return trace.roofline("swin_attn")
