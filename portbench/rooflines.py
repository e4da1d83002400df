"""The least time the H100 could take for the port's hand-written kernels
(K1 ``nn_grouped``, K2 ``coverage_fwd``, K3 ``coverage_bwd``), from the
operations and bytes their inputs need: the larger of operations over the
float32 peak and bytes over the memory rate (the arithmetic of the port's
kernel table, ``chip_smoke.py``'s ``nn_row`` and ``coverage_rows``, kept
here with the yardstick). A kernel's roofline share is this bound over
its measured device time.

  K1: 8 float32 operations per (query, reference) pair compared (three
      multiply-adds of the dot product and two adds), the pairs being
      those in the same group; bytes: the points and group rows read
      once, the distance (f32) and index (i64) written.
  K2: 30 operations per live (pixel, face) pair; bytes: the 24 edge
      coefficients per face and the coverage written.
  K3: 45 operations per live pair with a nonzero upstream gradient;
      bytes: the coefficients read and their gradient written, the
      upstream gradient read.
"""
from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(ops, nbytes):
    """(bound in ms, "operations" or "bytes")."""
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def k1(problems):
    """K1 over ``problems``: [(B, N, M, pairs or None, grouped)], pairs
    None meaning every pair (B * N * M)."""
    ops = nbytes = 0.0
    for B, N, M, pairs, grouped in problems:
        ops += 8.0 * (B * N * M if pairs is None else pairs)
        nbytes += 4.0 * B * (3 * N + 3 * M) + 12.0 * B * N
        if grouped:
            nbytes += 4.0 * B * (N + M)
    return bound_ms(ops, nbytes)


def k2(B, F, S, live_pairs):
    """K2 at batch B, F faces, an S x S render, ``live_pairs`` live
    (pixel, face) pairs."""
    return bound_ms(30.0 * live_pairs, 4.0 * (B * 24 * F + B * S * S))


def k3(B, F, S, live_pairs):
    """K3 likewise, ``live_pairs`` those with a nonzero upstream
    gradient."""
    return bound_ms(45.0 * live_pairs, 4.0 * (2 * B * 24 * F + B * S * S))
