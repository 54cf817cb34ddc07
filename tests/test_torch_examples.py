"""The five example twins of the PyTorch/H100 port (``examples/*_torch.py``)
run through ``main(argv)`` on the CPU at their smallest settings: exit 0
and the lines their originals print.  The quickstart's pka / sieve /
stem_root rows (K, representatives, eq. 5 error, eq. 6 speedup) equal
JAX's ``get_method(...).run`` + ``evaluate_metrics`` on the same program;
no twin imports the JAX side."""

import ast
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro.sampling import evaluate_metrics as jax_evaluate_metrics
from repro.sampling import get_method as jax_get_method
from repro.sim.simulate import simulate_program as jax_simulate_program
from repro.tracing.programs import get_program as jax_get_program
from repro_torch.analysis.lint import lint_paths

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
TWINS = ("quickstart", "sampled_simulation", "train_sampler", "serve_lm",
         "lm_pretrain")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the twins fit, embed and train with many small
    torch ops, which several test processes on one host slow down by
    oversubscribing the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_twin(name: str):
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"_twin_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(r) -> str:
    """The quickstart's table row, formatted as both examples print it."""
    return (f"{r.method:14s}{r.num_clusters:9d}{r.num_reps:6d}"
            f"{r.error_pct['cycles']:9.2f}{r.speedup:8.1f}x")


def test_quickstart_rows_match_jax(tmp_path, capsys, monkeypatch):
    twin = load_twin("quickstart")
    results = []
    evaluate_metrics = twin.evaluate_metrics

    def recording(*a, **kw):
        results.append(evaluate_metrics(*a, **kw))
        return results[-1]

    monkeypatch.setattr(twin, "evaluate_metrics", recording)
    argv = ["--device", "cpu", "--steps", "2", "--out", str(tmp_path / "qs")]
    assert twin.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "== nw: 255 kernel invocations =="
    for line, name in zip(out[1:5], ("GCL-Sampler", "PKA", "Sieve",
                                     "STEM+ROOT")):
        assert re.fullmatch(rf"{re.escape(name)}: K=\d+ clusters, \d+ "
                            rf"representative\(s\) \(\d+s\)", line), line
    assert out[6] == "method         clusters  reps  error %  speedup"
    assert out[7:] == [_row(r) for r in results]
    assert [r.method for r in results] == ["GCL-Sampler", "PKA", "Sieve",
                                           "STEM+ROOT"]
    assert results[0].num_clusters >= 1 and results[0].speedup > 1.0

    jprog = jax_get_program("nw")
    jmetrics = jax_simulate_program(jprog, "P1")
    for r, method_id in zip(results[1:], ("pka", "sieve", "stem_root")):
        jplan, _ = jax_get_method(method_id).run(jprog)
        j = jax_evaluate_metrics(jplan, jmetrics, program=jprog.name,
                                 platform="P1")
        assert (r.method, r.num_clusters, r.num_reps) == \
            (j.method, j.num_clusters, j.num_reps)
        assert r.error_pct == j.error_pct and r.speedup == j.speedup
        assert _row(r) == _row(j)
    # a second run on the same --out replays the artifacts
    assert twin.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[7:] == [
        _row(r) for r in results[:4]]


def test_sampled_simulation(capsys):
    twin = load_twin("sampled_simulation")
    assert twin.main(["--device", "cpu", "--steps", "2",
                      "--train-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^== lm:granite-3-2b: \d+ kernel invocations "
                     r"\(prefill \+ 1 decode steps\) ==$", out, re.M)
    k = re.search(r"^clusters: (\d+)  reps: (\d+)$", out, re.M)
    assert k and int(k.group(1)) >= 1 and int(k.group(2)) >= 1
    err = re.search(r"\(err ([\d.]+)%\)$", out, re.M)
    assert err and float(err.group(1)) < 100.0
    sp = re.search(r"^kernel-time speedup \(eq.6\): ([\d.]+)x$", out, re.M)
    assert sp and float(sp.group(1)) >= 1.0
    assert re.search(r"^simulator wall-time: .*x\)$", out, re.M)
    for m in ("ipc", "l1_hit", "l2_hit", "occupancy"):
        assert re.search(rf"^  {m:10s} full [\d.]+ sampled [\d.]+$", out,
                         re.M)
    assert re.search(r"^stage timings: graphs_s=.* train_s=.* embed_s=",
                     out, re.M)


def test_train_sampler(capsys):
    twin = load_twin("train_sampler")
    assert twin.main(["--device", "cpu", "--steps", "2", "--batch", "4"]) \
        == 0
    out = capsys.readouterr().out
    assert "== contrastive training on AlexNet (38 kernels) ==" in out
    assert re.search(r"^graphs: 38, ~\d+ nodes / ~\d+ edges each$", out,
                     re.M)
    assert re.search(r"^  step    1 loss=[\d.]+ ", out, re.M)
    v = re.search(r"^training done in \d+s; val_loss=([\d.]+) "
                  r"val_acc=([\d.]+)$", out, re.M)
    assert v and float(v.group(1)) > 0
    res = re.search(r"^K=(\d+) \(silhouette mode: \S+\) -> error "
                    r"([\d.]+)%, speedup ([\d.]+)x$", out, re.M)
    assert res and int(res.group(1)) >= 1 and float(res.group(3)) >= 1.0


def test_serve_lm(capsys):
    twin = load_twin("serve_lm")
    assert twin.main(["--device", "cpu", "--tokens", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for i, line in enumerate(lines):
        assert re.fullmatch(
            rf"\[serve\] batch {i}: prefill 64 toks x4 in \d+ms; decode 2 "
            rf"toks in \d+ms \([\d.]+ tok/s\); sample: \[\d+, \d+\]", line)


def test_serve_lm_prompt_is_a_multiple_of_the_ssd_chunk():
    """The original's 48-token prompt is not a multiple of the smoke
    mamba2-780m's SSD chunk; JAX's ``ssd_scan`` refuses it as the port's
    does, so the twin prompts 64 tokens."""
    import numpy as np

    from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
    from repro_torch.configs import smoke_arch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    twin = load_twin("serve_lm")
    chunk = smoke_arch("mamba2-780m").ssm_chunk
    assert 48 % chunk and twin.PROMPT_LEN % chunk == 0
    x = np.zeros((1, 48, 2, 4), np.float32)
    dt = np.ones((1, 48, 2), np.float32)
    bc = np.zeros((1, 48, 1, 4), np.float32)
    with pytest.raises(AssertionError):
        jax_ssd_scan(x, dt, -np.ones(2, np.float32), bc, bc, chunk)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssd_scan(t(x), t(dt), -torch.ones(2), t(bc), t(bc), chunk)


def test_lm_pretrain_trains_and_resumes(tmp_path, capsys):
    twin = load_twin("lm_pretrain")
    argv = ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck")]
    assert twin.main([*argv, "--steps", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[2] for line in out[:2]] == ["0", "1"]
    for line in out[:2]:
        assert re.fullmatch(r"\[train\] step +\d+ loss=[\d.]+ gnorm=[\d.]+ "
                            r"lr=[\d.e+-]+ \d+ms", line), line
    assert re.fullmatch(r"\[train\] done: 2 steps in [\d.]+s "
                        r"\(0 watchdog events\)", out[2])
    assert twin.main([*argv, "--steps", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] resumed from step 2"
    assert out[1].startswith("[train] step     2 ")


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_only_the_port(name):
    path = EXAMPLES / f"{name}_torch.py"
    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert "repro_torch" in mods
    assert not mods & {"repro", "jax", "jaxlib"}
    assert not [f for f in lint_paths([path]) if f.rule == "R5"]
    # the original's flags, plus --device defaulting to the card
    twin = load_twin(name)
    assert twin.main.__defaults__ == (None,)
    src = path.read_text()
    assert 'ap.add_argument("--device", default="cuda")' in src
    for flag in re.findall(r'add_argument\("(--[\w-]+)"',
                           (EXAMPLES / f"{name}.py").read_text()):
        assert f'add_argument("{flag}"' in src, flag
