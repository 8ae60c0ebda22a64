"""Two-level Front Coding string store (paper §3.2, Table 3), as in the JAX
package's ``core/fc.py``.

Bucket layout follows the paper: every (B+1)-th string is an uncompressed
*header*; the B strings after it store (lcp, suffix) relative to their
predecessor. Space accounting matches a byte-oriented FC encoding (1-2 byte
lcp/len + suffix bytes).

Decode: reconstructing string ``p`` of a bucket needs, for every char
position j, the *last* predecessor q <= p whose lcp <= j, a masked running
max over the (B+1, T) bucket instead of the sequential C++ scan. Extract,
Locate and LocatePrefix are batched over queries, on the store's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .searching import _ITERS, _lex_lt, ranged_searchsorted_keys
from .strings import encode_strings, pack_chars, prefix_bound_keys


def _lcp(a: bytes, b: bytes) -> int:
    m = min(len(a), len(b))
    for i in range(m):
        if a[i] != b[i]:
            return i
    return m


def _search_rows(keys: torch.Tensor, query: torch.Tensor, side: str) -> torch.Tensor:
    """``ranged_searchsorted_keys`` over [0, L) with one key array per lane:
    keys int32[B, L, C], query int32[B, C] -> int32[B]. The same halvings
    (``min(31, L.bit_length())`` of them), so an unsorted lane (a short last
    bucket's empty tail) gives the same insertion point too."""
    B, L, _ = keys.shape
    rows = torch.arange(B, device=keys.device)
    lo = torch.zeros(B, dtype=torch.int32, device=keys.device)
    hi = torch.full((B,), L, dtype=torch.int32, device=keys.device)
    for _ in range(min(_ITERS, max(1, L.bit_length()))):
        mid = (lo + hi) // 2
        row = keys[rows, mid.clamp(0, L - 1)]
        go_right = _lex_lt(row, query) if side == "left" else ~_lex_lt(query, row)
        valid = lo < hi
        lo, hi = (torch.where(valid & go_right, mid + 1, lo),
                  torch.where(valid & ~go_right, mid, hi))
    return lo


@dataclasses.dataclass(frozen=True)
class FrontCodedStore:
    header_chars: torch.Tensor  # uint8[NB, T]
    header_keys: torch.Tensor   # int32[NB, C]
    lcps: torch.Tensor          # int32[NB, B+1] (col 0 == 0 for the header)
    slens: torch.Tensor         # int32[NB, B+1] (suffix lengths)
    suf_off: torch.Tensor       # int32[NB, B+1] offsets into suffix_chars
    suffix_chars: torch.Tensor  # uint8[total_suffix]
    n_strings: int
    bucket_size: int
    max_chars: int
    n_buckets: int

    # -- construction (host) --------------------------------------------------
    @staticmethod
    def build(strings_sorted, bucket_size: int = 16, max_chars: int = 64, *,
              device) -> "FrontCodedStore":
        B = bucket_size
        enc = [
            (s.encode("utf-8")[:max_chars] if isinstance(s, str) else bytes(s)[:max_chars])
            for s in strings_sorted
        ]
        n = len(enc)
        nb = (n + B) // (B + 1)
        headers, lcps, slens, offs, chunks = [], [], [], [], []
        total = 0
        for b in range(nb):
            base = b * (B + 1)
            group = enc[base : base + B + 1]
            headers.append(group[0])
            row_l, row_s, row_o = [0], [len(group[0])], [total]
            chunks.append(group[0])
            total += len(group[0])
            for prev, cur in zip(group, group[1:]):
                l = _lcp(prev, cur)
                row_l.append(l)
                row_s.append(len(cur) - l)
                row_o.append(total)
                chunks.append(cur[l:])
                total += len(cur) - l
            while len(row_l) < B + 1:  # pad short last bucket
                row_l.append(0)
                row_s.append(0)
                row_o.append(total)
            lcps.append(row_l)
            slens.append(row_s)
            offs.append(row_o)
        hdr = encode_strings(headers, max_chars)
        suffix = np.frombuffer(b"".join(chunks), dtype=np.uint8).copy()
        if suffix.size == 0:
            suffix = np.zeros(1, dtype=np.uint8)
        i32 = lambda rows: torch.from_numpy(
            np.asarray(rows, dtype=np.int32).reshape(-1, B + 1)).to(device)
        return FrontCodedStore(
            header_chars=torch.from_numpy(hdr).to(device),
            header_keys=torch.from_numpy(pack_chars(hdr)).to(device),
            lcps=i32(lcps), slens=i32(slens), suf_off=i32(offs),
            suffix_chars=torch.from_numpy(suffix).to(device),
            n_strings=n, bucket_size=B, max_chars=max_chars, n_buckets=nb)

    # -- decode ---------------------------------------------------------------
    def _decode_buckets(self, b: torch.Tensor) -> torch.Tensor:
        """Decode all B+1 strings of each bucket b[i] -> uint8[n, B+1, T]."""
        n, Bp1, T = b.shape[0], self.bucket_size + 1, self.max_chars
        dev = self.lcps.device
        lcp, slen, off = self.lcps[b], self.slens[b], self.suf_off[b]   # [n, B+1]
        j = torch.arange(T, dtype=torch.int32, device=dev)
        q = torch.arange(Bp1, dtype=torch.int32, device=dev)
        # writer[q, j]: string q wrote char j; for target p the writer is the
        # last q <= p with writer[q, j] (the header, lcp 0, always writes)
        w = torch.where(lcp[:, :, None] <= j, q[None, :, None], -1)
        qs = torch.cummax(w, dim=1).values.clamp(min=0).reshape(n, -1).long()
        at = lambda a: torch.gather(a, 1, qs).reshape(n, Bp1, T)
        lcp_q, slen_q, off_q = at(lcp), at(slen), at(off)
        char_pos = off_q + (j - lcp_q)
        ch = self.suffix_chars[char_pos.clamp(0, self.suffix_chars.shape[0] - 1).long()]
        valid = j < lcp_q + slen_q
        return torch.where(valid, ch, 0).to(torch.uint8)

    def extract(self, ids: torch.Tensor) -> torch.Tensor:
        """ids[B] 0-based ranks -> uint8[B, T]."""
        Bp1 = self.bucket_size + 1
        i = ids.clamp(0, self.n_strings - 1).long()
        dec = self._decode_buckets(i // Bp1)
        return dec[torch.arange(i.shape[0], device=i.device), i % Bp1]

    # -- searches -------------------------------------------------------------
    def _rank_of_key(self, key: torch.Tensor, side: str) -> torch.Tensor:
        """Global insertion rank of packed keys [B, C] among all strings."""
        Bp1 = self.bucket_size + 1
        z = torch.zeros(key.shape[0], dtype=torch.int32, device=key.device)
        pos = ranged_searchsorted_keys(self.header_keys, key, z,
                                       z + self.n_buckets, side=side)
        b = (pos - 1).clamp(min=0)
        bkeys = pack_chars(self._decode_buckets(b.long()))          # [B, B+1, C]
        in_bucket = _search_rows(bkeys, key, side)
        return torch.clamp(b * Bp1 + in_bucket, max=self.n_strings)

    def locate(self, q_chars: torch.Tensor) -> torch.Tensor:
        """uint8[B, T] -> 0-based rank, -1 if absent."""
        pos = self._rank_of_key(pack_chars(q_chars), "left")
        row = self.extract(pos)
        hit = (pos < self.n_strings) & (row == q_chars).all(dim=-1)
        return torch.where(hit, pos, -1).to(torch.int32)

    def locate_prefix(self, q_chars: torch.Tensor, q_len: torch.Tensor):
        """-> (l, r) half-open 0-based rank range of strings with the prefix."""
        lo_keys, hi_keys = prefix_bound_keys(q_chars, q_len, self.max_chars)
        return self._rank_of_key(lo_keys, "left"), self._rank_of_key(hi_keys, "right")

    # -- space accounting -----------------------------------------------------
    def encoded_bytes(self) -> int:
        """Byte-oriented FC size: headers + (lcp,len) bytes + suffix bytes."""
        hdr_lens = int((self.header_chars != 0).sum())
        meta = int((self.lcps.numel() - self.n_buckets) * 2)  # 1B lcp + 1B len per string
        return hdr_lens + meta + int(self.suffix_chars.shape[0])

    def space_bytes(self) -> int:
        """In-memory footprint on the store's device."""
        return int(sum(t.numel() * t.element_size() for t in (
            self.header_chars, self.header_keys, self.lcps, self.slens,
            self.suf_off, self.suffix_chars)))
