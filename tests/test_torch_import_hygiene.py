"""The port stands alone: it imports no JAX and nothing of the JAX package,
and its entry points refuse to run silently on the CPU."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    import repro_torch

    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax_or_repro():
    names = _modules()
    assert "repro_torch.serve.frontend" in names and len(names) > 20
    assert {"repro_torch.models.transformer", "repro_torch.serve.lm",
            "repro_torch.kernels.flash_attention.ops", "repro_torch.data.lm",
            "repro_torch.configs.gemma2_2b", "repro_torch.optim.adamw",
            "repro_torch.optim.sparse_adam", "repro_torch.train.steps",
            "repro_torch.ckpt.manager", "repro_torch.launch.train"} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("root", ["src/repro_torch", "chip_smoke.py",
                                  "scripts/fm_forward_sweep.py",
                                  "scripts/attention_bwd_sweep.py"])
def test_no_source_names_jax_or_repro(root):
    p = ROOT / root
    files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"


def test_entry_points_without_device_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.backend import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.configs.recsys_common import MODEL_CLS
    from repro_torch.convert import (lm_params_from_arrays, qac_index_from_arrays,
                                     recsys_params_from_arrays)
    from repro_torch.core import build_qac_index
    from repro_torch.models.transformer import TransformerLM

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_qac_index(["a b", "a c"], [1.0, 2.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qac_index_from_arrays({}, {"k_default": 10})
    for kind, cls in MODEL_CLS.items():
        cfg = get_arch(kind).smoke_cfg
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            recsys_params_from_arrays(cfg, {})
        assert cls(cfg, device="cpu").device.type == "cpu"
    cfg = get_arch("gemma2-2b").smoke_cfg
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_arrays({}, cfg)
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"
    from repro_torch.launch import train as launch_train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1"])
    assert resolve_device("cpu").type == "cpu"
    qidx, _, _ = build_qac_index(["a b", "a c"], [1.0, 2.0], device="cpu")
    assert qidx.device.type == "cpu"


def test_packed_codecs_build_and_an_unknown_codec_raises():
    from repro_torch.core import build_qac_index
    from repro_torch.core.codecs import unpack_postings

    for codec in ("ef", "bitpack"):
        qidx, _, _ = build_qac_index(["a b", "a c", "b c d"], [1.0, 2.0, 3.0],
                                     postings_codec=codec, device="cpu")
        pk = qidx.index.packed
        assert pk.codec == codec and pk.n_post == qidx.index.n_postings
        assert (unpack_postings(pk) == qidx.index.postings.numpy()).all()
    qidx, _, _ = build_qac_index(["a b"], [1.0], postings_codec=None, device="cpu")
    assert qidx.index.packed is None
    with pytest.raises(ValueError, match="unknown postings_codec"):
        build_qac_index(["a b"], [1.0], postings_codec="vbyte", device="cpu")


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line, in the checkout and in a
    directory that holds chip_smoke.py alone."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        r = _run_smoke(cwd)
        assert r.returncode != 0, r.stdout
        assert '"ok"' not in r.stdout
