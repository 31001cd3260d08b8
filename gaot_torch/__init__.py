"""gaot_torch — GAOT in PyTorch with hand-written Hopper kernels.

The port of the JAX package ``gaot_tpu``, slice by slice; it imports
neither JAX nor ``gaot_tpu``. Entry points default to ``device="cuda"``.
"""
