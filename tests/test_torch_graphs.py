"""The port's ``data/graphs.py`` against the JAX package's (both numpy): the
same seeds give the same arrays, dtype and bits, for every function."""
import numpy as np
import pytest

from repro.data import graphs as jax_graphs
from repro_torch.data import graphs


def _same(got, want):
    got, want = (got,) if isinstance(got, np.ndarray) else got, \
        (want,) if isinstance(want, np.ndarray) else want
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("n_nodes,n_edges,seed,power", [(50, 400, 0, 1.5), (2_708, 10_556, 3, 1.5),
                                                        (1_000, 20_000, 7, 2.0)])
def test_random_graph_and_csr_equal_jax(n_nodes, n_edges, seed, power):
    got = graphs.random_graph(n_nodes, n_edges, seed=seed, power=power)
    want = jax_graphs.random_graph(n_nodes, n_edges, seed=seed, power=power)
    _same(got, want)
    _same(graphs.build_csr(*got, n_nodes), jax_graphs.build_csr(*want, n_nodes))


@pytest.mark.parametrize("fanouts,pads", [((15, 10), (600, 900)), ((3, 2, 2), (64, 100))])
def test_neighbor_sample_and_pad_equal_jax(fanouts, pads):
    """A 2- and a 3-hop sample, padded past and short of its size."""
    src, dst = graphs.random_graph(800, 8_000, seed=1)
    indptr, indices = graphs.build_csr(src, dst, 800)
    seeds = np.arange(0, 800, 50)
    got = graphs.neighbor_sample(indptr, indices, seeds, fanouts, np.random.default_rng(4))
    want = jax_graphs.neighbor_sample(indptr, indices, seeds, fanouts, np.random.default_rng(4))
    _same(got, want)
    _same(graphs.pad_subgraph(*got, *pads), jax_graphs.pad_subgraph(*want, *pads))
    _same(graphs.synth_positions(got[0]), jax_graphs.synth_positions(want[0]))


@pytest.mark.parametrize("batch,n_nodes,n_edges,n_species", [(8, 8, 16, 8), (16, 30, 64, 16)])
def test_batch_molecules_equals_jax(batch, n_nodes, n_edges, n_species):
    got = graphs.batch_molecules(np.random.default_rng(2), batch, n_nodes, n_edges, n_species)
    want = jax_graphs.batch_molecules(np.random.default_rng(2), batch, n_nodes, n_edges,
                                      n_species)
    _same(got, want)
