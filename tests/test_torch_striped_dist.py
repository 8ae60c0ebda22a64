"""``qac_serve_striped`` over a ``torch.distributed`` process group on the
CPU (``gloo``): S processes started by ``torch.multiprocessing.spawn`` meet
through a ``file://`` rendezvous under the test's temporary directory (no
TCP port), rank r serves stripe r, and every rank's merged answers, by the
"gather" merge and by the "butterfly" merge, must equal the single-process
loop over the stripes (held to the JAX package in ``test_torch_striped.py``)
at S = 2 and 4. At S = 3 "gather" still equals the loop and "butterfly"
raises. No JAX here: each process imports only the port."""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import build_qac_index, parse_queries
from repro_torch.core.striped import build_striped
from repro_torch.serve import qac_serve_step, qac_serve_striped
from repro_torch.text import SynthLogConfig, generate_query_log


def _batch(S):
    qs, sc = generate_query_log(SynthLogConfig(n_queries=600, vocab_size=150,
                                               mean_term_chars=4.0, seed=9))
    qidx, kept, _ = build_qac_index(qs, sc, postings_codec=None, device="cpu")
    fwd = qidx.completions.fwd_terms.numpy()
    striped = build_striped(fwd, np.arange(len(fwd), dtype=np.int32),
                            qidx.index.n_terms, S, device="cpu")
    rng = np.random.default_rng(S)
    partials = []
    for qi in rng.integers(0, len(kept), 24):
        toks = kept[qi].split()
        cut = rng.integers(1, len(toks[-1]) + 1)
        partials.append(" ".join(toks[:-1] + [toks[-1][:cut]]))
    pids, plen, _, suf, slen = parse_queries(qidx.dictionary, partials)
    return qidx, striped, (pids, plen, suf, slen)


def _worker(rank, S, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=S, rank=rank)
    try:
        qidx, striped, args = _batch(S)
        loop = qac_serve_striped(striped, qidx.dictionary, *args, k=10)
        assert torch.equal(loop, qac_serve_step(qidx, *args, k=10))
        got = {"gather": qac_serve_striped(striped, qidx.dictionary, *args, k=10,
                                           group=dist.group.WORLD, merge="gather")}
        try:
            got["butterfly"] = qac_serve_striped(striped, qidx.dictionary, *args, k=10,
                                                 group=dist.group.WORLD, merge="butterfly")
        except ValueError as e:
            assert S & (S - 1) and "power-of-two" in str(e), e
        for merge, g in got.items():
            assert torch.equal(g, loop), (rank, merge)
        np.save(os.path.join(out_dir, f"rank{rank}.npy"),
                np.stack([g.numpy() for g in got.values()]))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, S, timeout_s=120.0):
    ctx = mp.spawn(_worker, args=(S, f"file://{tmp_path}/rendezvous", str(tmp_path)),
                   nprocs=S, join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):       # raises a rank's exception
            assert time.monotonic() < deadline, f"{S} ranks did not finish in {timeout_s} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [np.load(tmp_path / f"rank{r}.npy") for r in range(S)]


@pytest.mark.parametrize("S", [2, 4])
def test_group_merges_equal_the_loop(tmp_path, S):
    outs = _spawn(tmp_path, S)
    assert all(o.shape == (2, 24, 10) for o in outs)
    assert all(np.array_equal(o, outs[0]) for o in outs)
    assert (outs[0] < 2**31 - 1).any()


def test_butterfly_raises_for_three_stripes(tmp_path):
    outs = _spawn(tmp_path, 3)
    assert all(o.shape == (1, 24, 10) for o in outs)      # "gather" only


def test_group_size_must_match_the_stripes():
    qidx, striped, args = _batch(2)
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="a group of 1 ranks"):
            qac_serve_striped(striped, qidx.dictionary, *args, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="merge"):
        qac_serve_striped(striped, qidx.dictionary, *args, merge="ring")
