"""The plain reference that decides ``correct``: torch and numpy only.

It imports nothing of the program (``gaussian_processes_tpu_torch``) and
nothing of the JAX package, takes the inputs the benchmark made, and works
out the factor, the solves, the log posterior and the samplers' transitions
again itself.  Every function takes an ``Arith``: ``float64`` for the
reference, ``tf32`` for the control (float32 with every matrix product's
operands rounded to TF32, the step a later change might be tempted by).
"""
