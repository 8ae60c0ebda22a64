"""The term dictionary (paper §3.2 "The Dictionary").

A lexicographically sorted, padded char matrix plus packed int32 chunk keys.
Locate / LocatePrefix are batched binary searches; Extract is a row gather.
Term ids are 1-based lexicographic ranks (0 = PAD).
"""
from __future__ import annotations

import dataclasses

import torch

from .types import MAX_TERM_CHARS
from .strings import encode_strings, pack_chars, prefix_bound_keys
from .searching import ranged_searchsorted_keys


@dataclasses.dataclass(frozen=True)
class TermDictionary:
    chars: torch.Tensor     # uint8[V, T] sorted
    keys: torch.Tensor      # int32[V, C] packed chunk keys
    n_terms: int
    max_chars: int

    @staticmethod
    def build(terms, max_chars: int = MAX_TERM_CHARS, *,
              device: torch.device) -> "TermDictionary":
        """terms: iterable of unique strings (host side)."""
        terms = sorted(set(terms))
        chars = encode_strings(terms, max_chars)
        keys = pack_chars(chars)
        return TermDictionary(chars=torch.from_numpy(chars).to(device),
                              keys=torch.from_numpy(keys).to(device),
                              n_terms=len(terms), max_chars=max_chars)

    def _search(self, keys, side):
        B = keys.shape[0]
        z = torch.zeros(B, dtype=torch.int32, device=keys.device)
        return ranged_searchsorted_keys(self.keys, keys, z, z + self.n_terms,
                                        side=side)

    def locate(self, q_chars: torch.Tensor) -> torch.Tensor:
        """Locate(t): uint8[B, T] -> 1-based term id, 0 if absent."""
        pos = self._search(pack_chars(q_chars), "left")
        row = self.chars[pos.clamp(max=self.n_terms - 1)]
        hit = (pos < self.n_terms) & (row == q_chars).all(-1)
        return torch.where(hit, pos + 1, 0).to(torch.int32)

    def locate_prefix(self, q_chars: torch.Tensor, q_len: torch.Tensor):
        """LocatePrefix(suffix) -> (l, r) 1-based half-open term-id ranges.

        No term with the prefix gives l == r; a zero-length prefix matches
        every term: (1, V+1).
        """
        lo_keys, hi_keys = prefix_bound_keys(q_chars, q_len, self.max_chars)
        return (self._search(lo_keys, "left") + 1,
                self._search(hi_keys, "right") + 1)

    def extract(self, term_ids: torch.Tensor) -> torch.Tensor:
        """Extract(id): 1-based ids[B] -> uint8[B, T] (PAD id -> zeros)."""
        idx = (term_ids - 1).clamp(0, self.n_terms - 1)
        rows = self.chars[idx]
        return torch.where((term_ids > 0)[:, None], rows, 0).to(torch.uint8)
