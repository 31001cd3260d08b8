"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterparts of ``gaot_tpu/ops/pallas``: each module holds its kernels'
wrappers (CUDA tensors launch the kernel, CPU tensors take the plain
version), the plain versions, and a launch counter per kernel
(``launches``, a dict keyed by kernel name).
"""
from . import flash_attention, fused_ffn, multiply_reduce

WRAPPERS = (multiply_reduce, flash_attention, fused_ffn)


def reset_launches() -> None:
    for mod in WRAPPERS:
        for name in mod.launches:
            mod.launches[name] = 0


def launch_counts() -> dict:
    return {name: n for mod in WRAPPERS for name, n in mod.launches.items()}
