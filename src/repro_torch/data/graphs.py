"""Graph data pipeline: synthesis, CSR, fanout neighbor sampling, batching.

The JAX package's ``data/graphs.py``, numpy only, kept here as its own copy:
the same seed gives the same arrays, bit for bit.

``neighbor_sample`` is a GraphSAGE-style sampler (numpy, host side): for
each GNN layer it uniformly samples up to ``fanout[l]`` in-neighbors of the
frontier, emitting a padded edge list per hop. The minibatch_lg shape
depends on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def random_graph(n_nodes: int, n_edges: int, seed: int = 0, power: float = 1.5):
    """Power-law-ish random directed graph; returns (src, dst) int32 arrays."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-like degree skew via zipf on targets
    ranks = rng.zipf(power, size=n_edges).astype(np.int64)
    dst = (ranks - 1) % n_nodes
    src = rng.integers(0, n_nodes, n_edges)
    keep = src != dst
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """In-neighbor CSR: for node v, neighbors(v) = indices[indptr[v]:indptr[v+1]]."""
    order = np.argsort(dst, kind="stable")
    src_sorted = src[order]
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(counts)
    return indptr, src_sorted.astype(np.int32)


def neighbor_sample(indptr, indices, seeds: np.ndarray, fanouts, rng):
    """k-hop uniform fanout sampling.

    Returns (nodes, senders, receivers): `nodes` is the union frontier
    (seeds first); edges are indexed into `nodes`; padded edges use sender =
    receiver = 0 with mask 0 — handled by the caller's padding step.
    """
    nodes = list(seeds.tolist())
    node_pos = {int(v): i for i, v in enumerate(nodes)}
    senders, receivers = [], []
    frontier = list(seeds.tolist())
    for f in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = int(indptr[v]), int(indptr[v + 1])
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            sel = rng.choice(deg, size=take, replace=False) + lo
            for u in indices[sel]:
                u = int(u)
                if u not in node_pos:
                    node_pos[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                senders.append(node_pos[u])
                receivers.append(node_pos[v])
        frontier = nxt
    return (np.asarray(nodes, np.int32), np.asarray(senders, np.int32),
            np.asarray(receivers, np.int32))


def pad_subgraph(nodes, senders, receivers, n_nodes_pad: int, n_edges_pad: int):
    """Pad sampled subgraph to fixed shapes; returns arrays + masks."""
    nn, ne = len(nodes), len(senders)
    nodes_p = np.zeros(n_nodes_pad, np.int32)
    nodes_p[: min(nn, n_nodes_pad)] = nodes[:n_nodes_pad]
    s = np.zeros(n_edges_pad, np.int32)
    r = np.zeros(n_edges_pad, np.int32)
    m = np.zeros(n_edges_pad, np.float32)
    ne = min(ne, n_edges_pad)
    s[:ne], r[:ne], m[:ne] = senders[:ne], receivers[:ne], 1.0
    node_mask = np.zeros(n_nodes_pad, np.float32)
    node_mask[: min(nn, n_nodes_pad)] = 1.0
    return nodes_p, s, r, m, node_mask


def synth_positions(node_ids: np.ndarray) -> np.ndarray:
    """Deterministic unit-sphere positions for graphs without coordinates
    (DESIGN.md §Arch-applicability: Cora/ogbn-products have no 3D geometry)."""
    rng = np.random.default_rng(12345)
    # hash-like: reseed from ids for determinism independent of batch
    g = np.random.default_rng(np.asarray(node_ids, np.uint32) + 1)
    p = g.normal(size=(len(node_ids), 3))
    return (p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-9)).astype(np.float32)


def batch_molecules(rng, batch: int, n_nodes: int, n_edges: int, n_species: int,
                    box: float = 4.0):
    """Random molecular batch: positions in a box, radius-graph edges
    (capped at n_edges per molecule), block-diagonal batching."""
    N, E = batch * n_nodes, batch * n_edges
    pos = rng.uniform(0, box, size=(batch, n_nodes, 3)).astype(np.float32)
    species = rng.integers(0, n_species, size=(batch, n_nodes)).astype(np.int32)
    senders = np.zeros(E, np.int32)
    receivers = np.zeros(E, np.int32)
    emask = np.zeros(E, np.float32)
    for b in range(batch):
        d = np.linalg.norm(pos[b][:, None] - pos[b][None], axis=-1)
        np.fill_diagonal(d, np.inf)
        cand = np.argwhere(d < 2.5)
        cand = cand[rng.permutation(len(cand))][:n_edges]
        off = b * n_edges
        nb = b * n_nodes
        senders[off : off + len(cand)] = cand[:, 0] + nb
        receivers[off : off + len(cand)] = cand[:, 1] + nb
        emask[off : off + len(cand)] = 1.0
    graph_ids = np.repeat(np.arange(batch, dtype=np.int32), n_nodes)
    return (pos.reshape(N, 3), species.reshape(N), np.ones(N, np.float32),
            senders, receivers, emask, graph_ids)
