"""Plain PyTorch references that decide ``correct``.

Each module recomputes, from the frames and generators the benchmark made,
everything the program derives (features, Grams, sampled constraint rows,
detected constraints, solves, applied maps) and judges the program's
outputs against it. ``precision="float64"`` is the reference;
``precision="tf32"`` is the control: the same algorithm one step below the
configuration's float32, every product taken on operands rounded to TF32's
10-bit mantissa and summed in float32.

Nothing here imports ``aggforce_torch``, ``aggforce_tpu`` or ``jax``.
"""
