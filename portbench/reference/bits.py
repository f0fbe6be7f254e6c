"""Benchmark reference: a frozen copy of aruco3_tpu_torch/utils/bits.py.

Bit-twiddling utilities shared by the dictionary matcher and decoder.

Counterpart of ``aruco3_tpu/utils/bits.py``.  Code words are carried as
(…, 2) uint32 (lo, hi) pairs or as ±1 bit-plane vectors, so the Hamming
search is one float32 matrix product.  Bit 0 is the least-significant bit
of the u64 code word everywhere.
"""

from __future__ import annotations

import numpy as np
import torch


def hamming_distance(a: int, b: int) -> int:
    """Hamming distance between two u64 code words (host-side scalar)."""
    return int(bin((int(a) ^ int(b)) & 0xFFFFFFFFFFFFFFFF).count("1"))


def pack_u64_to_u32(codes: np.ndarray) -> np.ndarray:
    """(N,) uint64 -> (N, 2) uint32 with column 0 = low word, 1 = high word."""
    codes = np.asarray(codes, dtype=np.uint64)
    out = np.empty(codes.shape + (2,), dtype=np.uint32)
    out[..., 0] = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[..., 1] = (codes >> np.uint64(32)).astype(np.uint32)
    return out


def unpack_u32_to_u64(pairs: np.ndarray) -> np.ndarray:
    """(N, 2) uint32 (lo, hi) -> (N,) uint64."""
    pairs = np.asarray(pairs, dtype=np.uint32)
    return pairs[..., 0].astype(np.uint64) | (
        pairs[..., 1].astype(np.uint64) << np.uint64(32)
    )


def codes_to_bitplanes(codes: np.ndarray, num_bits: int) -> np.ndarray:
    """(N,) uint64 -> (N, num_bits) float32 in {-1, +1}; bit 0 first.

    With this encoding dist(x, y) = (num_bits - x . y) / 2 for two
    bit-plane vectors, so the whole-dictionary Hamming scan is one matmul.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    shifts = np.arange(num_bits, dtype=np.uint64)
    bits = (codes[..., None] >> shifts) & np.uint64(1)
    return (bits.astype(np.float32) * 2.0) - 1.0


def bitplane_hamming(
    query: torch.Tensor, codebook_t: torch.Tensor, num_bits: int
) -> torch.Tensor:
    """(M, num_bits) ±1 @ (num_bits, N) ±1 -> (M, N) int32 distances.

    The dot products are sums of ±1 and exact in float32 at any summation
    order, so the result does not depend on the matmul's precision mode as
    long as TF32 is off (the caller's responsibility on CUDA)."""
    dots = query @ codebook_t
    return ((num_bits - dots) * 0.5).to(torch.int32)
