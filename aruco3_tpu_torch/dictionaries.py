"""Fiducial marker dictionaries and the batched Hamming-distance matcher.

Counterpart of ``aruco3_tpu/dictionaries.py``.  The codebooks are read from
the JAX package's data file by path (importing that package would import
jax).  The nearest-code search is one float32 ±1 matmul followed by an
argmin whose ties go to the lowest code index.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from .utils.bits import (
    bitplane_hamming,
    codes_to_bitplanes,
    pack_u64_to_u32,
    unpack_u32_to_u64,
)

_DATA_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "aruco3_tpu",
    "data",
    "codebooks.npz",
)


@functools.lru_cache(maxsize=1)
def _load_raw():
    with np.load(_DATA_PATH, allow_pickle=False) as z:
        names = [str(n) for n in z["names"]]
        num_bits = {n: int(b) for n, b in zip(names, z["num_bits"])}
        tau = {n: int(t) for n, t in zip(names, z["tau"])}
        codes = {n: unpack_u32_to_u64(z[f"codes_{n}"]) for n in names}
    codes["ARUCO_DEFAULT"] = codes["ARUCO"]
    num_bits["ARUCO_DEFAULT"] = num_bits["ARUCO"]
    tau["ARUCO_DEFAULT"] = tau["ARUCO"]
    return codes, num_bits, tau


def calculate_tau(code_list: np.ndarray) -> int:
    """Minimum pairwise Hamming distance over a codebook (255 for < 2)."""
    codes = np.asarray(code_list, dtype=np.uint64)
    n = len(codes)
    if n < 2:
        return 255
    best = 255
    chunk = 512
    for i in range(0, n, chunk):
        x = codes[i : i + chunk, None] ^ codes[None, :]
        d = np.zeros(x.shape, dtype=np.uint8)
        v = x.copy()
        while v.any():
            d += (v & np.uint64(1)).astype(np.uint8)
            v >>= np.uint64(1)
        rows = np.arange(i, min(i + chunk, n)) - i
        cols = np.arange(i, min(i + chunk, n))
        d[rows, cols] = 255
        best = min(best, int(d.min()))
    return best


@functools.lru_cache(maxsize=None)
def _cached_tau(name: str) -> int:
    codes, _, _ = _load_raw()
    return calculate_tau(codes[name])


def get_dictionary_names() -> list[str]:
    """All registered dictionary names."""
    codes, _, _ = _load_raw()
    return sorted(codes.keys())


@dataclass(frozen=True)
class ARDictionary:
    """A named marker dictionary plus its matcher tables (per device)."""

    name: str
    num_bits: int
    tau: int
    code_list: np.ndarray  # (N,) uint64, host-side
    _tables: dict = field(default_factory=dict, repr=False, compare=False)

    @staticmethod
    def new_from_named_dict(name: str) -> "ARDictionary":
        """Look up a dictionary by (case-insensitive) name; KeyError if
        unknown.  tau == 0 dictionaries get the minimum pairwise distance."""
        codes, num_bits, tau = _load_raw()
        key = name.upper()
        if key not in codes:
            raise KeyError(
                f"unknown dictionary {name!r}; known: {sorted(codes)}"
            )
        t = tau[key]
        if t == 0:
            t = _cached_tau(key)
        return ARDictionary(
            name=key, num_bits=num_bits[key], tau=t, code_list=codes[key]
        )

    def __len__(self) -> int:
        return len(self.code_list)

    def get_mark_size(self) -> int:
        """Marker side in cells including the black border ring."""
        return int(np.ceil(np.sqrt(self.num_bits))) + 2

    @property
    def inner_size(self) -> int:
        return self.get_mark_size() - 2

    def codebook_bitplanes_t(self, device) -> torch.Tensor:
        """(num_bits, N) float32 ±1 codebook on ``device`` (cached)."""
        key = ("bp_t", str(torch.device(device)))
        if key not in self._tables:
            bp = codes_to_bitplanes(self.code_list, self.num_bits)
            self._tables[key] = torch.from_numpy(
                np.ascontiguousarray(bp.T)
            ).to(device)
        return self._tables[key]

    def codebook_u32(self) -> np.ndarray:
        """(N, 2) uint32 (lo, hi) code words."""
        return pack_u64_to_u32(self.code_list)

    def find_nearest_bits(self, query_bits: torch.Tensor):
        """(..., num_bits) {0,1} -> (ids, dists), each (...,) int32.

        Ties resolve to the lowest code index: the argmin runs over
        dist * N + index, which is unique per code."""
        q = query_bits.to(torch.float32) * 2.0 - 1.0
        lead = q.shape[:-1]
        q = q.reshape(-1, self.num_bits)
        dists = bitplane_hamming(
            q, self.codebook_bitplanes_t(q.device), self.num_bits
        )
        n = dists.shape[-1]
        order = torch.arange(n, device=q.device, dtype=torch.int64)
        ids = torch.argmin(dists.to(torch.int64) * n + order, dim=-1)
        best = torch.gather(dists, 1, ids[:, None])[:, 0]
        return ids.to(torch.int32).reshape(lead), best.reshape(lead)

    def find_nearest(self, bits: int) -> tuple[int, int]:
        """Scalar convenience wrapper: (id, distance) of the nearest code."""
        vec = (int(bits) >> np.arange(self.num_bits, dtype=np.uint64)) & 1
        ids, dists = self.find_nearest_bits(
            torch.from_numpy(vec.astype(np.int64)[None, :])
        )
        return int(ids[0]), int(dists[0])

    def try_find_nearest(self, bits: int):
        """(id, dist) iff dist < tau, else None."""
        idx, dist = self.find_nearest(bits)
        if dist < self.tau:
            return idx, dist
        return None

    def make_binary_image(self, marker_id: int) -> tuple[int, np.ndarray]:
        """(width, bits) boolean row-major marker image with black border,
        LSB-first, with the reference's interleaved border emission."""
        code = int(self.code_list[marker_id])
        width = self.get_mark_size()
        bits: list[bool] = [False] * width
        for i in range(self.num_bits):
            if len(bits) % width == 0:
                bits.append(False)
            bits.append(bool(code & (1 << i)))
            if len(bits) % width == width - 1:
                bits.append(False)
        bits.extend([False] * width)
        return width, np.array(bits, dtype=bool)

    def marker_bit_matrix(self, marker_id: int) -> np.ndarray:
        """(mark_size, mark_size) bool marker incl. border, row-major."""
        width, bits = self.make_binary_image(marker_id)
        return bits.reshape(width, width)
