"""The plain reference the benchmark holds the port to: frozen copies of the
port's model, heads, criterion and schedule in plain PyTorch, run in f32
with TF32 off. It imports nothing of the program (``psalm_tpu_torch``) and
takes nothing the program made: the benchmark draws the weights, inputs
and point draws from the seed and hands the same to both.

Departures from the port's arithmetic, each on purpose:

* Precision. Everything in f32 (parameters, activations, products), with
  ``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` False;
  the program computes in bf16 (eval: bf16 parameters too).
* Kernels. The deformable sampler (K1, and its backward K2 by autograd),
  the Swin window-attention core (K3) and softmax attention are
  ``plain_ops.py``'s plain versions, frozen copies of the port's plain
  twins; Phi's attention is the einsum branch (the whole L x L product,
  masked), which computes the function K5 computes causally.
* Scope. No KV cache, mesh, tensor parallelism, quantized or LoRA linears,
  window clamp or dense pixel-decoder mode (``phi.py``, ``psalm.py``,
  ``layers.py``); the scipy matcher only (``criterion.py``).
* Data parallelism. A cell of several cards runs the reference on the same
  ranks, each its rows; the criterion's counts are summed over the group
  and each gradient is all-reduced whole (``drivers/train.py::
  reference_steps``), where the program sums flat buckets and updates
  ZeRO slices of the moments.
* AdamW. ``torch.optim.AdamW`` on whole parameters with a copy of the
  port's warmup-cosine schedule; the program runs the same optimizer on its
  slices.
* The control. ``layers.LOWER`` set to a float8 type rounds every linear's
  and convolution's input and weight to it (one scale a tensor) before an
  f32 product: the reference computed in the precision below the
  configuration's, for ``calibrate.py``. Autograd rounds the gradient
  through each of those roundings to the same float8 type, unscaled, so
  most gradients underflow: the control's gradient numbers read about 1,
  and its loss is its steadier witness (``PERF.md``).
"""
