"""The port's launcher, ``python -m repro_torch.launch.serve``, in every mode
through ``main([..., "--device", "cpu"])``, with the argument sets with which
``scripts/check_seed.sh`` runs the JAX package's launcher, so that every
``--check`` gate is known to be reachable. The online sets run 16 sessions,
not 64: on the CPU the plain engines take ~35 s for the 1,937 requests of
64 sessions (and as long again for the one-request-per-dispatch reference),
and the gates (every row bit-identical to that reference, a nonzero hit
rate, closed callables, root spans equal to the telemetry) hold at 414.

Also: ``--interactive`` prints the strings that JAX's ``qac_serve_step``
gives on JAX's index of the same log; ``--stripes 2`` and ``--routed`` count
the fused step's results; ``repro_torch.obs.report`` reads a trace as
``scripts/obs_report.py`` does (the script loaded by path); ``QACArch``'s
observability fields, ``obs_config()``, ``cells()`` and ``QAC_SHAPES``, and
``corpus_stats``, equal the JAX package's."""
import dataclasses
import functools
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.qac_common import QAC_SHAPES as JAX_SHAPES
from repro.configs.qac_common import QACArch as JaxArch
from repro.core import build_qac_index as jax_build
from repro.core import corpus_stats as jax_corpus_stats
from repro.core import parse_queries as jax_parse
from repro.core.strings import decode_string as jax_decode
from repro.serve.qac import qac_serve_step as jax_step
from repro.text import SynthLogConfig, generate_query_log
from repro_torch.configs.qac_common import QAC_SHAPES, QACArch
from repro_torch.core import corpus_stats
from repro_torch.launch.serve import main, sample_partials
from repro_torch.obs import ObsConfig, load_jsonl, report, request_trees

ROOT = Path(__file__).resolve().parents[1]
ONLINE = ["--online", "--check", "--queries", "3000", "--sessions", "16",
          "--slack-us", "5000"]


def run(capsys, *argv) -> str:
    assert main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out


def n_results(out: str) -> int:
    return int(re.search(r"QPS \(host CPU\), (\d+) results", out).group(1))


def test_online_check(capsys):
    out = run(capsys, *ONLINE)
    assert "[serve] online check OK: 414 requests bit-identical" in out


def test_cluster_drill_check(capsys):
    out = run(capsys, "--online", "--cluster", "2", "--drill", "--check", "--queries",
              "800", "--sessions", "16", "--keystroke-ms", "5", "--max-batch", "8",
              "--slack-us", "2000")
    assert "[serve] cluster check OK:" in out and "re-routed" in out


def test_freshness_check(capsys):
    out = run(capsys, "--freshness", "--check", "--queries", "2000", "--sessions", "24",
              "--mutations", "18", "--max-batch", "8", "--slack-us", "2000",
              "--keystroke-ms", "5")
    assert "[serve] freshness check OK:" in out


def load_jax_report():
    spec = importlib.util.spec_from_file_location("jax_obs_report",
                                                  ROOT / "scripts" / "obs_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_observe_check_and_report(capsys, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    out = run(capsys, *ONLINE, "--observe", "--trace-sample", "4", "--trace-out", path)
    assert "[serve] observe check OK:" in out and "[serve] online check OK:" in out
    assert report.main([path, "--check"]) == 0
    out = capsys.readouterr().out
    assert "## per-stage latency budget" in out and "\ncheck OK:" in out
    jax_report = load_jax_report()
    trees = request_trees(load_jsonl(path)[0])
    assert trees
    assert report.stage_table(trees) == jax_report.stage_table(trees)
    assert report.check_trace(trees) == jax_report.check_trace(trees)
    kid = next(t for t in trees.values() if t[1])
    kid[1][0]["dur_us"] += kid[0]["dur_us"] + 1.0          # a child past its root
    with pytest.raises(AssertionError):
        report.check_trace(trees)


def test_interactive_prints_jax_strings(capsys):
    qs, sc = generate_query_log(SynthLogConfig(n_queries=2000))
    jq, kept, _ = jax_build(qs, sc)
    partial = sample_partials(kept, 12)[7]
    jp = jax_parse(jq.dictionary, [partial])
    docids = np.asarray(jax.jit(functools.partial(jax_step, jq, k=10, use_kernel=False))(
        jp[0], jp[1], jp[3], jp[4]))[0]
    want = []
    for d in docids[docids < 2**31 - 1]:
        terms, n = jq.completions.extract(jax.numpy.int32(d))
        chars = np.asarray(jq.dictionary.extract(terms[: int(n)]))
        want.append(" ".join(jax_decode(c) for c in chars))
    assert want
    out = run(capsys, "--queries", "2000", "--interactive", partial)
    got = re.findall(r"^   #\s*\d+  (.*)$", out, flags=re.M)
    assert got == want


def test_stripes_and_routed_count_the_fused_results(capsys):
    base = ["--queries", "2000", "--batch", "64"]
    fused = n_results(run(capsys, *base))
    out = run(capsys, *base, "--stripes", "2")
    assert n_results(out) == fused > 0
    assert "[serve] stripe 1: single-term torch_ref" in out
    assert n_results(run(capsys, *base, "--routed")) == fused


def test_arch_obs_cells_and_corpus_stats_equal_jax():
    for kw in ({}, dict(obs_trace_sample_every=4, obs_slo_target_us=20_000.0)):
        got, want = QACArch(**kw).obs_config(), JaxArch(**kw).obs_config()
        assert isinstance(got, ObsConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for f in ("obs_trace_sample_every", "obs_slo_target_us", "obs_slo_objective"):
        assert getattr(QACArch(), f) == getattr(JaxArch(), f)
    assert QAC_SHAPES == JAX_SHAPES
    assert [dataclasses.astuple(c) for c in QACArch().cells()] == \
        [dataclasses.astuple(c) for c in JaxArch().cells()]
    qs, sc = generate_query_log(SynthLogConfig(n_queries=500, seed=3))
    _, kept, _ = jax_build(qs, sc, postings_codec=None)
    assert dataclasses.asdict(corpus_stats(kept)) == \
        dataclasses.asdict(jax_corpus_stats(kept))
    assert corpus_stats([]).n_queries == 0


def test_device_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--queries", "100"])


def test_every_jax_flag_is_there():
    """The port's parser has every flag of the JAX launcher and
    ``--device``, with the defaults the card's run relies on."""
    from repro_torch.launch.serve import build_parser

    src = (ROOT / "src" / "repro" / "launch" / "serve.py").read_text()
    jax_flags = re.findall(r'add_argument\("(--[a-z-]+)"', src)
    assert len(jax_flags) == 20
    ours = {a.option_strings[0]: a.default for a in build_parser()._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert set(ours) == set(jax_flags) | {"--device"}
    assert ours["--queries"] == 20_000 and ours["--batch"] == 256
    assert ours["--sessions"] == 64 and ours["--device"] == "cuda"
