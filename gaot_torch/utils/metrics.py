"""Evaluation metrics (the port's own copy of ``gaot_tpu/utils/metrics.py``).

Implements the reference metric exactly (src/utils/metrics.py:11-75):
per-sample relative L1 error per variable chunk after global-stat
normalization, aggregated as the median over samples then the mean over
chunks. Host-side NumPy — metrics run on small test-time arrays.
"""
from __future__ import annotations

import numpy as np

EPSILON = 1e-10


def compute_batch_errors(gtr: np.ndarray, prd: np.ndarray, metadata) -> np.ndarray:
    """Per-sample relative L1 errors per variable chunk.

    Args:
        gtr: ground truth, shape [batch, time, space, var]
        prd: prediction, same shape
        metadata: dataset Metadata (global_mean/global_std/active/chunked vars)

    Returns:
        np.ndarray of shape [batch, num_chunks]
    """
    gtr = np.asarray(gtr, dtype=np.float64)
    prd = np.asarray(prd, dtype=np.float64)
    active = list(metadata.active_variables)

    mean = np.asarray(metadata.global_mean, dtype=np.float64)[active].reshape(1, 1, 1, -1)
    std = np.asarray(metadata.global_std, dtype=np.float64)[active].reshape(1, 1, 1, -1)

    original_chunks = list(metadata.chunked_variables)
    chunked_vars = [original_chunks[i] for i in active]
    unique_chunks = sorted(set(chunked_vars))
    chunk_map = {old: new for new, old in enumerate(unique_chunks)}
    adjusted = np.array([chunk_map[c] for c in chunked_vars])
    num_chunks = len(unique_chunks)

    gtr_norm = (gtr - mean) / std
    prd_norm = (prd - mean) / std

    abs_error = np.abs(gtr_norm - prd_norm).sum(axis=(1, 2))   # [batch, var]
    gtr_abs = np.abs(gtr_norm).sum(axis=(1, 2))                # [batch, var]

    batch = abs_error.shape[0]
    error_per_chunk = np.zeros((batch, num_chunks))
    gtr_per_chunk = np.zeros((batch, num_chunks))
    for v, chunk in enumerate(adjusted):
        error_per_chunk[:, chunk] += abs_error[:, v]
        gtr_per_chunk[:, chunk] += gtr_abs[:, v]

    return error_per_chunk / (gtr_per_chunk + EPSILON)


def compute_final_metric(all_relative_errors: np.ndarray) -> float:
    """Median over samples per chunk, then mean over chunks.

    Matches torch.median semantics (lower of the two middle elements for even
    sample counts), unlike np.median which averages them.
    """
    errs = np.asarray(all_relative_errors, dtype=np.float64)  # [num_samples, num_chunks]
    n = errs.shape[0]
    sorted_errs = np.sort(errs, axis=0)
    median = sorted_errs[(n - 1) // 2]  # torch.median: lower middle element
    return float(median.mean())
