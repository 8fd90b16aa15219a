"""The benchmark's plain references: PyTorch and NumPy only.

Nothing here imports the program (the ``_torch`` port), the JAX package
or anything either of them made.  Each reference takes the inputs the
benchmark made (weights, images, galleries, batches) and works out again
what the program derives from them.

``precision`` selects the arithmetic of every convolution and matrix
product: ``"fp32"`` (TF32 off, the configurations' stated precision) or
``"tf32"``, the control: every operand of those products rounded to
TF32's 10 mantissa bits, forward and backward, with fp32 accumulation,
which is what a TF32 tensor core computes.
"""
