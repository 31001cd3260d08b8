"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterparts of ``gaot_tpu/ops/pallas``: each module holds one kernel's
wrapper (CUDA tensors launch the kernel, CPU tensors take the plain
version), the plain version, and a launch counter.
"""
from . import flash_attention, fused_ffn, multiply_reduce

WRAPPERS = (multiply_reduce, flash_attention, fused_ffn)


def reset_launches() -> None:
    for mod in WRAPPERS:
        mod.launches = 0


def launch_counts() -> dict:
    return {mod.KERNEL_NAME: mod.launches for mod in WRAPPERS}
