"""The compressed postings device format (paper §3.2), as the JAX package
builds it (``core/codecs.py``), and its plain PyTorch decoder.

Postings are split into ``PACK_BLOCK``-entry blocks; each block stores the
deltas from its minimum either fixed-width bitpacked or as a per-block
Elias-Fano pair (256-bit upper-bits bitmap + fixed-width lows), whichever
is smaller, in one int32 word stream with a per-block directory
(base docid, bit width | is_ef, word offset). ``pack_postings`` is the
host numpy build, moved to the device once; ``packed_lookup`` is the O(1)
random-access decode, transcribed from the JAX package's shift/mask body.
The CUDA kernels decode with ``qac::packed_lookup`` in ``csrc/
qac_common.cuh``, the same arithmetic in ``uint32_t``.

Stream layout (bit offsets little-endian within int32 words):

  block b (= postings[128*b : 128*(b+1)], the tail block padded by repeating
  the last value; pads are never addressable because lookups clamp to
  ``n_post - 1``):
    base[b]    = min(block)
    meta[b]    = width | (is_ef << 6)
    wordoff[b] = first int32 word of the block's payload
  bitpack payload: 128 deltas at ``width`` bits each  -> 4*width words
  EF payload:      8-word bitmap with bit (j + high_j) set, where
                   high_j = delta_j >> width (width = the EF low-bit count
                   l = max(0, msb-7)), followed by 128 packed ``width``-bit
                   lows                              -> 8 + 4*width words
  EF is chosen per block only when the block is sorted and the EF payload is
  strictly smaller; ``codec="bitpack"`` disables it, so the decoder can skip
  the bitmap select.

The space-study codecs (the paper's Table 4: ``BitWriter``/``BitReader``,
``EFList``, ``ef_encode``/``ef_decode``, ``pef_bits``, ``vbyte_encode``/
``vbyte_decode``, ``bitpack_bits``, ``index_bpi``) are host numpy, copied
from the JAX package, and lie on no serving path: they report the bits per
posting of whole-list codecs (EF, partitioned EF, VByte, delta + fixed-width
bitpacking) for a space study.

torch's ``>>`` on int32 is arithmetic and its int32 multiply is not the
JAX shift/wrap arithmetic this transcribes, so the plain decoder works in
int64 on the words' unsigned 32-bit values and masks every shift and
product back to 32 bits.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_U64 = np.uint64
_FULL64 = (1 << 64) - 1

PACK_BLOCK = 128          # postings per block
EF_BITMAP_WORDS = 8       # 256-bit upper-bits bitmap per EF block
_META_EF_BIT = 6          # meta = width | (is_ef << _META_EF_BIT)
CODECS = ("ef", "bitpack")


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Vectorized int bit_length; exact for 0 <= x < 2**53."""
    return np.frexp(np.asarray(x, dtype=np.float64))[1].astype(np.int64)


# ---------------------------------------------------------------- bit I/O
class BitWriter:
    """Append-only little-endian bit stream over uint64 words.

    Word-level numpy throughout: ``write``/``unary`` are O(bits/64) scalar
    ops, ``write_many``/``unary_many`` are fully vectorized (one
    ``bitwise_or.at`` scatter per word touched) — the per-bit Python loops
    this replaces dominated both index build and ``bench_compression``.
    """

    def __init__(self):
        self._words = np.zeros(4, dtype=_U64)
        self._nbits = 0

    def _reserve(self, nbits: int) -> None:
        need = (nbits + 63) >> 6
        if need > len(self._words):
            grown = np.zeros(max(need, 2 * len(self._words)), dtype=_U64)
            grown[: len(self._words)] = self._words
            self._words = grown

    def write(self, value: int, n_bits: int) -> None:
        if n_bits <= 0:
            return
        v = int(value) & ((1 << n_bits) - 1)
        pos = self._nbits
        self._reserve(pos + n_bits)
        self._nbits = pos + n_bits
        w, b = divmod(pos, 64)
        while True:
            self._words[w] |= _U64((v << b) & _FULL64)
            take = 64 - b
            if n_bits <= take:
                return
            v >>= take
            n_bits -= take
            w += 1
            b = 0

    def write_many(self, values: np.ndarray, n_bits: int) -> None:
        """Append ``len(values)`` fields of ``n_bits`` bits each."""
        vals = np.asarray(values).astype(_U64)
        n = len(vals)
        if n == 0 or n_bits == 0:
            return
        assert 0 < n_bits <= 64
        if n_bits < 64:
            vals = vals & _U64((1 << n_bits) - 1)
        pos0 = self._nbits
        self._reserve(pos0 + n * n_bits)
        pos = _U64(pos0) + np.arange(n, dtype=_U64) * _U64(n_bits)
        w = (pos >> _U64(6)).astype(np.int64)
        b = pos & _U64(63)
        np.bitwise_or.at(self._words, w, vals << b)
        spill = (b + _U64(n_bits)) > _U64(64)
        if spill.any():
            bs = b[spill]
            np.bitwise_or.at(self._words, w[spill] + 1,
                             vals[spill] >> (_U64(64) - bs))
        self._nbits = pos0 + n * n_bits

    def unary(self, n: int) -> None:
        self.write(0, n)
        self.write(1, 1)

    def unary_many(self, gaps: np.ndarray) -> None:
        """Append one unary code (``gap`` zeros then a one) per entry."""
        g = np.asarray(gaps, dtype=np.int64)
        if len(g) == 0:
            return
        stops = self._nbits + np.cumsum(g + 1) - 1
        end = int(stops[-1]) + 1
        self._reserve(end)
        np.bitwise_or.at(self._words, (stops >> 6).astype(np.int64),
                         _U64(1) << (stops.astype(_U64) & _U64(63)))
        self._nbits = end

    def pad_to(self, n_bits: int) -> None:
        """Advance the cursor to an absolute bit position (zero fill)."""
        assert n_bits >= self._nbits
        self._reserve(n_bits)
        self._nbits = n_bits

    def n_bits(self) -> int:
        return self._nbits

    def array(self) -> np.ndarray:
        return self._words[: max(1, (self._nbits + 63) >> 6)].copy()


class BitReader:
    """Cursor over a BitWriter stream; same word-level discipline."""

    def __init__(self, words: np.ndarray):
        self.words = np.asarray(words, dtype=_U64)
        self.pos = 0

    def read(self, n_bits: int) -> int:
        out = 0
        got = 0
        while got < n_bits:
            w, b = divmod(self.pos, 64)
            take = min(64 - b, n_bits - got)
            out |= ((int(self.words[w]) >> b) & ((1 << take) - 1)) << got
            got += take
            self.pos += take
        return out

    def read_many(self, count: int, n_bits: int) -> np.ndarray:
        """Read ``count`` fields of ``n_bits`` bits -> int64[count]."""
        if count == 0 or n_bits == 0:
            return np.zeros(count, dtype=np.int64)
        assert 0 < n_bits <= 63
        L = len(self.words)
        pos = _U64(self.pos) + np.arange(count, dtype=_U64) * _U64(n_bits)
        w = (pos >> _U64(6)).astype(np.int64)
        b = pos & _U64(63)
        lo = self.words[w] >> b
        w1 = np.minimum(w + 1, L - 1)
        sh = (_U64(64) - b) & _U64(63)
        hi = np.where(b == 0, _U64(0), self.words[w1] << sh)
        out = (lo | hi) & _U64((1 << n_bits) - 1)
        self.pos += count * n_bits
        return out.astype(np.int64)

    def unary(self) -> int:
        n = 0
        while True:
            w, b = divmod(self.pos, 64)
            bit = (int(self.words[w]) >> b) & 1
            self.pos += 1
            if bit:
                return n
            n += 1

    def unary_many(self, count: int) -> np.ndarray:
        """Decode ``count`` unary codes -> int64[count] (the zero runs)."""
        if count == 0:
            return np.zeros(0, dtype=np.int64)
        w0 = self.pos >> 6
        tail = self.words[w0:]
        if not np.little_endian:  # pragma: no cover - scalar fallback
            return np.array([self.unary() for _ in range(count)], np.int64)
        bits = np.unpackbits(tail.view(np.uint8), bitorder="little")
        bits = bits[self.pos - (w0 << 6):]
        ones = np.flatnonzero(bits)[:count]
        assert len(ones) == count, "unary stream truncated"
        self.pos += int(ones[-1]) + 1
        return np.diff(ones, prepend=np.int64(-1)) - 1


# ---------------------------------------------------------------- Elias-Fano
@dataclasses.dataclass
class EFList:
    words: np.ndarray
    n: int
    universe: int
    low_bits: int

    def bits(self) -> int:
        # canonical EF size: n*ceil(log2(U/n)) + 2n (+ o(n) select, excluded
        # consistently for all codecs)
        return len(self.words) * 64


def ef_encode(values: np.ndarray, universe: int | None = None) -> EFList:
    v = np.asarray(values, dtype=np.int64)
    assert (np.diff(v) >= 0).all(), "EF needs a sorted sequence"
    n = len(v)
    u = int(universe if universe is not None else (v[-1] + 1 if n else 1))
    l = max(0, int(math.floor(math.log2(max(u, 1) / max(n, 1))))) if n else 0
    w = BitWriter()
    if n:
        # low bits, packed; then high bits as unary-coded gaps
        w.write_many(v & ((1 << l) - 1), l)
        w.unary_many(np.diff(v >> l, prepend=np.int64(0)))
    return EFList(words=w.array(), n=n, universe=u, low_bits=l)


def ef_decode(ef: EFList) -> np.ndarray:
    r = BitReader(ef.words)
    lows = r.read_many(ef.n, ef.low_bits)
    high = np.cumsum(r.unary_many(ef.n)) if ef.n else lows
    return (high << ef.low_bits) | lows


def pef_bits(values: np.ndarray, partition: int = 128) -> int:
    """Uniformly-partitioned EF (Ottaviano-Venturini, uniform variant)."""
    v = np.asarray(values, dtype=np.int64)
    total = 0
    for i in range(0, len(v), partition):
        chunk = v[i : i + partition]
        base = int(chunk[0])
        total += 32  # per-partition header (base + size)
        total += ef_encode(chunk - base).bits()
    return total


# ---------------------------------------------------------------- VByte
def vbyte_encode(values: np.ndarray) -> bytes:
    v = np.asarray(values, dtype=np.int64)
    deltas = np.concatenate([[v[0] + 1], np.diff(v)]) if len(v) else v
    out = bytearray()
    for d in deltas:
        d = int(d)
        while True:
            b = d & 0x7F
            d >>= 7
            if d:
                out.append(b)
            else:
                out.append(b | 0x80)
                break
    return bytes(out)


def vbyte_decode(data: bytes, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    pos = 0
    cur = -1
    for i in range(n):
        d = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            d |= (b & 0x7F) << shift
            shift += 7
            if b & 0x80:
                break
        cur += d
        out[i] = cur
    return out


# ---------------------------------------------------------------- bitpacked deltas
def bitpack_bits(values: np.ndarray, block: int = 128) -> int:
    """Delta + per-block fixed-width packing (FastPFor-lite), size only."""
    v = np.asarray(values, dtype=np.int64)
    if not len(v):
        return 0
    gaps = np.concatenate([[v[0] + 1], np.diff(v)])
    total = 0
    for i in range(0, len(gaps), block):
        chunk = gaps[i : i + block]
        width = max(1, int(_bit_length(chunk.max())))
        total += 8 + width * len(chunk)   # 8-bit width header
    return total


def index_bpi(lists: list[np.ndarray], method: str) -> float:
    """Average bits per posting over an inverted index."""
    bits = 0
    n = 0
    for lst in lists:
        if len(lst) == 0:
            continue
        n += len(lst)
        if method == "ef":
            bits += ef_encode(lst).bits()
        elif method == "pef":
            bits += pef_bits(lst)
        elif method == "vbyte":
            bits += len(vbyte_encode(lst)) * 8
        elif method == "bitpack":
            bits += bitpack_bits(lst)
        elif method == "raw32":
            bits += 32 * len(lst)
        else:
            raise ValueError(method)
    return bits / max(n, 1)


# ------------------------------------------------- device block format
@dataclasses.dataclass(frozen=True)
class PackedPostings:
    """Compressed postings on the device (see the module docstring).

    ``codec`` records the build-time choice: "ef" allows per-block EF
    payloads (bitmap-select decode), "bitpack" forbids them, so
    ``packed_lookup(..., ef=False)`` skips the bitmap select.
    """

    words: torch.Tensor     # int32[W] payload bit stream
    base: torch.Tensor      # int32[NB] per-block minimum docid
    meta: torch.Tensor      # int32[NB] width | is_ef<<6
    wordoff: torch.Tensor   # int32[NB] first payload word per block
    n_post: int
    codec: str

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(f"unknown packed codec {self.codec!r}")

    @property
    def has_ef(self) -> bool:
        return self.codec == "ef"

    def nbytes(self) -> int:
        return 4 * (int(self.words.shape[0]) + 3 * int(self.base.shape[0]))

    def bits_per_int(self) -> float:
        return self.nbytes() * 8.0 / max(self.n_post, 1)

    def lookup(self, ptr: torch.Tensor) -> torch.Tensor:
        """``packed_lookup`` over this index's arrays."""
        return packed_lookup(self.words, self.base, self.meta, self.wordoff,
                             ptr, n_post=self.n_post, ef=self.has_ef)


def pack_postings(postings: np.ndarray, codec: str = "ef", *,
                  device: torch.device) -> PackedPostings:
    """Encode a postings array into the device block format on ``device``
    (host numpy build, one move to the device)."""
    if codec not in CODECS:
        raise ValueError(f"unknown packed codec {codec!r}")
    v = np.asarray(postings, dtype=np.int64).ravel()
    n = int(v.size)
    nb = max(1, -(-n // PACK_BLOCK))
    vp = np.empty(nb * PACK_BLOCK, dtype=np.int64)
    vp[:n] = v
    vp[n:] = v[n - 1] if n else 0          # pads are never addressable
    blocks = vp.reshape(nb, PACK_BLOCK)
    base = blocks.min(axis=1)
    d = blocks - base[:, None]
    width = _bit_length(d.max(axis=1))
    block_sorted = (np.diff(blocks, axis=1) >= 0).all(axis=1)
    l = np.maximum(width - 7, 0)           # EF high parts then fit 256 bits
    use_ef = ((codec == "ef") & block_sorted
              & (EF_BITMAP_WORDS + 4 * l < 4 * width))
    wfield = np.where(use_ef, l, width)
    nwords = np.where(use_ef, EF_BITMAP_WORDS + 4 * l, 4 * width)
    wordoff = np.concatenate([[0], np.cumsum(nwords)[:-1]])
    total = int(nwords.sum())

    # every block's payload, grouped by field width: the stream's bits run
    # LSB-first through little-endian int32 words, as numpy's packbits with
    # bitorder="little" lays them out
    words32 = np.zeros(max(total, 1), dtype=np.uint32)
    ef_rows = np.flatnonzero(use_ef)
    if ef_rows.size:
        high = d[ef_rows] >> l[ef_rows, None]
        bits = np.zeros((ef_rows.size, EF_BITMAP_WORDS * 32), dtype=np.uint8)
        bits[np.arange(ef_rows.size)[:, None], high + np.arange(PACK_BLOCK)] = 1
        words32[wordoff[ef_rows, None] + np.arange(EF_BITMAP_WORDS)] = np.packbits(
            bits, axis=1, bitorder="little").view("<u4")
    lows = np.where(use_ef[:, None], d & ((1 << l[:, None]) - 1), d)
    skip = np.where(use_ef, EF_BITMAP_WORDS, 0)
    for w in np.unique(wfield[wfield > 0]).tolist():
        for rows in _chunks(np.flatnonzero(wfield == w)):
            words32[(wordoff + skip)[rows, None] + np.arange(4 * w)] = _pack_fields(
                lows[rows], w)

    meta = wfield | (use_ef.astype(np.int64) << _META_EF_BIT)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return PackedPostings(words=to(words32.view(np.int32)),
                          base=to(base.astype(np.int32)),
                          meta=to(meta.astype(np.int32)),
                          wordoff=to(wordoff.astype(np.int32)),
                          n_post=n, codec=codec)


def unpack_postings(pk: PackedPostings) -> np.ndarray:
    """Host decode of the full stream -> int32[n_post]."""
    words = pk.words.cpu().numpy().view(np.uint32)
    base = pk.base.cpu().numpy().astype(np.int64)
    meta = pk.meta.cpu().numpy()
    wordoff = pk.wordoff.cpu().numpy().astype(np.int64)
    width = meta & ((1 << _META_EF_BIT) - 1)
    is_ef = ((meta >> _META_EF_BIT) & 1).astype(bool)
    d = np.zeros((len(base), PACK_BLOCK), dtype=np.int64)
    skip = np.where(is_ef, EF_BITMAP_WORDS, 0)
    for w in np.unique(width[width > 0]).tolist():
        for rows in _chunks(np.flatnonzero(width == w)):
            d[rows] = _unpack_fields(
                words[(wordoff + skip)[rows, None] + np.arange(4 * w)], w)
    ef_rows = np.flatnonzero(is_ef)
    if ef_rows.size:
        bits = np.unpackbits(np.ascontiguousarray(
            words[wordoff[ef_rows, None] + np.arange(EF_BITMAP_WORDS)]).view(np.uint8),
            axis=1, bitorder="little")
        r, pos = np.nonzero(bits)
        assert r.size == ef_rows.size * PACK_BLOCK, "EF bitmap corrupt"
        high = pos.reshape(ef_rows.size, PACK_BLOCK) - np.arange(PACK_BLOCK)
        d[ef_rows] |= high << width[ef_rows, None]
    out = base[:, None] + d
    return out.reshape(-1)[: pk.n_post].astype(np.int32)


def _chunks(rows: np.ndarray, size: int = 4096):
    """``rows`` in slices of at most ``size`` (bounds the bit matrices)."""
    return [rows[i:i + size] for i in range(0, rows.size, size)]


def _pack_fields(vals: np.ndarray, w: int) -> np.ndarray:
    """int64[nb, PACK_BLOCK] values of ``w`` bits -> uint32[nb, 4w], value i
    of a row at bits [i*w, (i+1)*w) of its words."""
    bits = ((vals[:, :, None] >> np.arange(w)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(len(vals), -1), axis=1,
                       bitorder="little").view("<u4")


def _unpack_fields(words: np.ndarray, w: int) -> np.ndarray:
    """``_pack_fields`` inverted: uint32[nb, 4w] -> int64[nb, PACK_BLOCK]."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=1,
                         bitorder="little").reshape(len(words), PACK_BLOCK, w)
    return (bits.astype(np.int64) << np.arange(w)).sum(-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 lanes holding unsigned 32-bit values; the
    JAX version's wrapping int32 multiply is the product masked to 32 bits."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def packed_lookup(words, base, meta, wordoff, ptr, *, n_post: int, ef: bool):
    """Random-access decode: postings[min(max(ptr, 0), n_post-1)] -> int32.

    The JAX package's ``codecs.packed_lookup`` step by step: every read is
    clamped as there (the pointer to ``[0, max(n_post-1, 0)]``, both payload
    words and each bitmap word to ``W-1``), both shift-by-32 guards are kept,
    and ``ef=True`` decodes the bitmap select for every lane and lets the
    block's meta flag pick it or the plain field. ``ef=False`` promises no
    block is EF and skips the select. Callers mask out-of-list lanes.
    """
    W = words.shape[0]
    u = words.to(torch.int64) & _M32         # the unsigned words
    p = ptr.to(torch.int64).clamp(0, max(n_post - 1, 0))
    b = p >> 7                               # // PACK_BLOCK
    j = p & (PACK_BLOCK - 1)
    bb = base[b].to(torch.int64)
    mm = meta[b].to(torch.int64)
    off = wordoff[b].to(torch.int64)
    wf = mm & ((1 << _META_EF_BIT) - 1)
    is_ef = (mm >> _META_EF_BIT) & 1
    # fixed-width field j of the low/bitpack payload
    bit = j * wf
    wi = (off + (is_ef << 3)) + (bit >> 5)
    bo = bit & 31
    w0 = u[wi.clamp(max=W - 1)]
    w1 = u[(wi + 1).clamp(max=W - 1)]
    straddle = torch.where(bo == 0, 0, (w1 << ((32 - bo) & 31)) & _M32)
    mask = torch.where(wf == 0, 0, _M32 >> (32 - wf.clamp(min=1)))
    low = ((w0 >> bo) | straddle) & mask
    if not ef:
        return (bb + low).to(torch.int32)
    # EF upper bits: the j-th set bit of the 8-word bitmap. For bitpack
    # blocks these reads are clamped garbage that the final ``where`` drops.
    r = j
    sel_word = torch.zeros_like(j)
    sel_base = torch.zeros_like(j)
    found = torch.zeros_like(j, dtype=torch.bool)
    for t in range(EF_BITMAP_WORDS):
        wt = u[(off + t).clamp(max=W - 1)]
        c = popcount32(wt)
        here = ~found & (r < c)
        sel_word = torch.where(here, wt, sel_word)
        sel_base = torch.where(here, t << 5, sel_base)
        r = torch.where(found | here, r, r - c)
        found = found | here
    # binary strip: position of the r-th set bit inside sel_word
    pos = torch.zeros_like(j)
    cur = sel_word
    for s in (16, 8, 4, 2, 1):
        c = popcount32(cur & ((1 << s) - 1))
        go = c <= r
        r = torch.where(go, r - c, r)
        pos = pos + torch.where(go, s, 0)
        cur = torch.where(go, cur >> s, cur & ((1 << s) - 1))
    high = sel_base + pos - j
    val = torch.where(is_ef == 1, ((high << wf) | low) & _M32, low)
    return (bb + val).to(torch.int32)
