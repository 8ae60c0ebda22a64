"""``python -m repro_torch.launch.train`` in process on the CPU
(``--device cpu``): a dense LM, a MoE LM, the GNN (MACE) and a recsys arch
at their smoke configs with the fault drill (one restart from the last
checkpoint, the loss falling)."""
import pytest
import torch

from repro_torch.launch import train as launch_train


@pytest.fixture(autouse=True)
def _one_thread():
    """Small shapes: one intra-op thread. Under the suite's parallel workers
    torch's default thread pool oversubscribes the cores, and a loop of tiny
    ops then runs tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _done(out: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith("done: "))
    restarts = int(line.split("restarts=")[1].split(",")[0])
    first, last = (float(x) for x in line.split(" loss ")[1].split(" on ")[0].split(" -> "))
    return {"restarts": restarts, "first": first, "last": last, "line": line}


@pytest.mark.parametrize("arch,steps", [("smollm-360m", 30), ("bst", 20), ("mace", 20),
                                        ("qwen2-moe-a2.7b", 20)])
def test_train_launcher_drill_on_cpu(tmp_path, capsys, arch, steps):
    assert launch_train.main(["--arch", arch, "--steps", str(steps), "--drill",
                              "--ckpt-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    d = _done(out)
    assert d["restarts"] == 1, d["line"]
    assert f"[driver] restored from step {steps // 2 // 10 * 10}" in out
    assert d["line"].startswith(f"done: {steps} steps") and d["line"].endswith("on cpu")
    if arch != "bst":
        assert d["last"] < d["first"], d["line"]
