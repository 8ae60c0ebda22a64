"""Byte-string <-> packed int32 chunk-key conversion.

Strings are padded uint8 rows; for sorted search 3 bytes are packed per int32
chunk (big-endian within the chunk), so that chunkwise signed-integer
comparison equals lexicographic byte comparison and every chunk stays
non-negative even for 0xFF padding.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import CHARS_PER_CHUNK


def n_chunks(max_chars: int) -> int:
    return (max_chars + CHARS_PER_CHUNK - 1) // CHARS_PER_CHUNK


def encode_strings(strings, max_chars: int) -> np.ndarray:
    """List of bytes/str -> uint8[N, max_chars] padded with 0 (host-side).

    Each string's first ``max_chars`` bytes of UTF-8, scattered from one
    concatenated buffer."""
    bs = [s.encode("utf-8") if isinstance(s, str) else bytes(s) for s in strings]
    n = np.fromiter(map(len, bs), np.int64, len(bs))
    keep = np.minimum(n, max_chars)
    row = np.repeat(np.arange(len(bs)), keep)
    col = np.arange(int(keep.sum())) - np.repeat(np.cumsum(keep) - keep, keep)
    src = np.frombuffer(b"".join(bs), dtype=np.uint8)
    out = np.zeros((len(bs), max_chars), dtype=np.uint8)
    out[row, col] = src[np.repeat(np.cumsum(n) - n, keep) + col]
    return out


def decode_string(row) -> str:
    row = np.asarray(row, dtype=np.uint8)
    end = int(np.argmax(row == 0)) if (row == 0).any() else len(row)
    return bytes(row[:end]).decode("utf-8", errors="replace")


def pack_chars(chars):
    """uint8[..., T] -> int32[..., ceil(T/3)] big-endian 3-byte chunks.

    Takes a numpy array (host build) or a tensor (device queries).
    """
    T = chars.shape[-1]
    pad = (-T) % CHARS_PER_CHUNK
    if isinstance(chars, np.ndarray):
        if pad:
            chars = np.concatenate(
                [chars, np.zeros(chars.shape[:-1] + (pad,), chars.dtype)], -1)
        c = chars.astype(np.int32)
    else:
        if pad:
            chars = torch.cat(
                [chars, chars.new_zeros(chars.shape[:-1] + (pad,))], -1)
        c = chars.to(torch.int32)
    c = c.reshape(chars.shape[:-1] + (-1, CHARS_PER_CHUNK))
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def prefix_bound_keys(chars: torch.Tensor, length: torch.Tensor, max_chars: int):
    """Packed keys for the lower/upper bound of a prefix search.

    chars: uint8[B, T] prefix padded with 0; length: int32[B]. Positions
    >= length are 0x00 in lo_key and 0xFF in hi_key, so
    ``searchsorted(lo, 'left') .. searchsorted(hi, 'right')`` brackets
    exactly the strings with that prefix.
    """
    idx = torch.arange(max_chars, dtype=torch.int32, device=chars.device)
    mask = idx[None, :] < length.reshape(-1, 1)
    lo = torch.where(mask, chars, torch.zeros_like(chars))
    hi = torch.where(mask, chars, torch.full_like(chars, 255))
    return pack_chars(lo), pack_chars(hi)
