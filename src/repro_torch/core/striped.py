"""The docid-striped QAC index (the JAX package's ``core/striped.py``).

Stripe s owns the docids with ``docid % n_stripes == s``: every stripe sees
every score band, so each stripe's "first k in docid order" merges into the
global top-k with one k-wide gather and a min-k (``serve/qac.py::
qac_serve_striped``). The stripes' arrays are padded to common shapes and
stacked on a leading stripe axis, on one device; a process group of S ranks
serves one stripe a rank. The arrays are the JAX package's, bit for bit:
the postings keep global docids, and a stripe's forward row of docid d is
row d // S (``LocalFwd``), which the multi-term engine's kernel reads
through its ``fwd_stride``.

The JAX package's ``local_heap_kernel_fits`` previews the TPU's VMEM gate
for a stripe; the port has no such gate (the index sits in device memory,
``core/search.py``), so it is not carried over.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..backend import resolve_device
from .codecs import PackedPostings, pack_postings
from .inverted_index import InvertedIndex
from .rmq import RangeMin
from .types import INF_DOCID


@dataclasses.dataclass(frozen=True)
class StripedQACIndex:
    postings: torch.Tensor      # int32[S, P_pad] global docids, ascending
    offsets: torch.Tensor       # int32[S, V+2]
    minimal: torch.Tensor       # int32[S, V+2]
    fwd_terms: torch.Tensor     # int32[S, N_loc, M] row = docid // S
    fwd_nterms: torch.Tensor    # int32[S, N_loc]
    rmq_values: torch.Tensor    # int32[S, n_pad] (padded minimal)
    rmq_st: torch.Tensor        # int32[S, levels, nb]
    rmq_ib: torch.Tensor        # int8[S, IB_LEVELS, n_pad] in-block argmins
    n_stripes: int
    n_terms: int
    n_local_docs: int
    postings_pad: int
    max_terms: int
    rmq_levels: int
    rmq_blocks: int
    # compressed postings, stacked per stripe: every stripe packs its padded
    # postings row (a common n_post == postings_pad), so the block
    # directories agree in shape and only the word streams are zero-padded
    # to a common length. pp_codec None <=> the fields are absent.
    pp_words: torch.Tensor | None = None    # int32[S, W_pad]
    pp_base: torch.Tensor | None = None     # int32[S, NB]
    pp_meta: torch.Tensor | None = None     # int32[S, NB]
    pp_wordoff: torch.Tensor | None = None  # int32[S, NB]
    pp_codec: str | None = None

    @property
    def device(self) -> torch.device:
        return self.postings.device

    def stripe_nbytes(self, s: int = 0) -> int:
        """Device bytes of stripe ``s``'s arrays (its share of the stack)."""
        return sum(t[s].numel() * t.element_size() for t in vars(self).values()
                   if isinstance(t, torch.Tensor))


class LocalFwd:
    """A stripe's forward index under the ``Completions.extract`` contract:
    docid d is row d // S, valid while 0 <= d < n_local_docs * S."""

    def __init__(self, fwd_terms, fwd_nterms, n_stripes: int):
        self.fwd_terms = fwd_terms          # [N_loc, M]
        self.fwd_nterms = fwd_nterms
        self.n_stripes = n_stripes

    @property
    def fwd_stride(self) -> int:
        return self.n_stripes

    def extract(self, docid):
        n_loc = self.fwd_terms.shape[0]
        row_idx = torch.div(docid, self.n_stripes, rounding_mode="floor").clamp(0, n_loc - 1)
        valid = (docid >= 0) & (docid.to(torch.int64) < n_loc * self.n_stripes)
        row = torch.where(valid[..., None], self.fwd_terms[row_idx], 0)
        return row, torch.where(valid, self.fwd_nterms[row_idx], 0)


def build_striped(term_rows: np.ndarray, docid_of_row: np.ndarray,
                  n_terms: int, n_stripes: int,
                  postings_codec: str | None = "ef", *,
                  device=None) -> StripedQACIndex:
    """Split a corpus into docid stripes and stack them (host numpy, one
    move to ``device``, default the card).

    ``term_rows`` int32[N, M] (1-based term ids, 0 pad), ``docid_of_row``
    int32[N]. ``postings_codec`` ("ef" default, "bitpack", or None) also
    packs each stripe's padded postings row, so the engines can read the
    compressed postings of a stripe as they read an index's.
    """
    device = resolve_device(device)
    cpu = torch.device("cpu")
    term_rows = np.asarray(term_rows, np.int32)
    docid_of_row = np.asarray(docid_of_row, np.int32)
    n, m = term_rows.shape
    n_loc = (n + n_stripes - 1) // n_stripes
    posts, offs, mins, fwds, fnts, rvals, rsts, ribs = [], [], [], [], [], [], [], []
    for s in range(n_stripes):
        keep = (docid_of_row % n_stripes) == s
        # the stripes pack their padded rows below; no packing here
        sub_idx = InvertedIndex.build(term_rows[keep], docid_of_row[keep], n_terms,
                                      postings_codec=None, device=cpu)
        posts.append(sub_idx.postings.numpy())
        offs.append(sub_idx.offsets.numpy())
        mins.append(sub_idx.minimal.numpy())
        fwd = np.zeros((n_loc, m), np.int32)
        fnt = np.zeros((n_loc,), np.int32)
        rows_s = term_rows[keep]
        d_s = docid_of_row[keep] // n_stripes
        fwd[d_s] = rows_s
        fnt[d_s] = (rows_s != 0).sum(1)
        fwds.append(fwd)
        fnts.append(fnt)
        rm = RangeMin.build(mins[-1], device=cpu)
        rvals.append(rm.values.numpy())
        ribs.append(rm.ib.numpy())
        rsts.append((rm.st_pos.numpy(), rm.levels, rm.n_blocks))
    p_pad = max(len(p) for p in posts)
    posts = [np.pad(p, (0, p_pad - len(p)), constant_values=INF_DOCID) for p in posts]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pk_fields = {}
    if postings_codec is not None:
        # a shared n_post (== p_pad) gives every stripe the same block count;
        # the INF pads pack to width-0 blocks past the first transition
        pks = [pack_postings(p, postings_codec, device=cpu) for p in posts]
        w_pad = max(int(pk.words.shape[0]) for pk in pks)
        pk_fields = dict(
            pp_words=to(np.stack([np.pad(pk.words.numpy(), (0, w_pad - pk.words.shape[0]))
                                  for pk in pks])),
            pp_base=to(np.stack([pk.base.numpy() for pk in pks])),
            pp_meta=to(np.stack([pk.meta.numpy() for pk in pks])),
            pp_wordoff=to(np.stack([pk.wordoff.numpy() for pk in pks])),
            pp_codec=postings_codec)
    levels = max(st[1] for st in rsts)
    nb = max(st[2] for st in rsts)
    sts = [np.pad(stp, ((0, levels - lv), (0, nb - b)), mode="edge")
           for stp, lv, b in rsts]
    return StripedQACIndex(
        postings=to(np.stack(posts)), offsets=to(np.stack(offs)),
        minimal=to(np.stack(mins)), fwd_terms=to(np.stack(fwds)),
        fwd_nterms=to(np.stack(fnts)), rmq_values=to(np.stack(rvals)),
        rmq_st=to(np.stack(sts)), rmq_ib=to(np.stack(ribs)),
        n_stripes=n_stripes, n_terms=n_terms, n_local_docs=n_loc,
        postings_pad=p_pad, max_terms=m, rmq_levels=levels, rmq_blocks=nb,
        **pk_fields)


def local_index(striped: StripedQACIndex, s: int = 0):
    """Stripe ``s``'s (InvertedIndex, LocalFwd, RangeMin) views: slices of
    the stacked tensors, no copy."""
    packed = None
    if striped.pp_words is not None:
        packed = PackedPostings(words=striped.pp_words[s], base=striped.pp_base[s],
                                meta=striped.pp_meta[s], wordoff=striped.pp_wordoff[s],
                                n_post=striped.postings_pad, codec=striped.pp_codec)
    idx = InvertedIndex(postings=striped.postings[s], offsets=striped.offsets[s],
                        minimal=striped.minimal[s], n_terms=striped.n_terms,
                        n_postings=striped.postings_pad, packed=packed)
    fwd = LocalFwd(striped.fwd_terms[s], striped.fwd_nterms[s], striped.n_stripes)
    rmq = RangeMin(values=striped.rmq_values[s], st_pos=striped.rmq_st[s],
                   ib=striped.rmq_ib[s], n=striped.minimal.shape[-1],
                   n_blocks=striped.rmq_blocks, levels=striped.rmq_levels)
    return idx, fwd, rmq
