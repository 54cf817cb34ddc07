"""The port's linter linted (counterpart of ``tests/test_analysis_lint.py``):
fixture pairs for rules R1–R5, waivers, the hot call graph's pinned
entries, the repository run against ``baseline.json``, the baseline diff
and the CLI; and the parts JAX's linter shares (``parse_waivers``,
``Finding``, ``module_name_for``, ``diff_baseline``) held to
``repro.analysis`` on the same inputs."""

import ast
import json
from collections import Counter
from pathlib import Path

import pytest

from repro.analysis import lint as jlint
from repro.analysis import rules as jrules
from repro_torch.analysis import RULES, Finding
from repro_torch.analysis.callgraph import (
    DISPATCH_LOOPS, HOT_ENTRIES, INGEST_ENTRIES, ModuleIndex, build_graph,
)
from repro_torch.analysis.lint import (
    BASELINE_PATH, collect_files, diff_baseline, lint_paths, load_baseline,
    main, module_name_for, write_baseline,
)
from repro_torch.analysis.rules import parse_waivers, unexplained_waivers

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "lint_torch"
PORT = REPO / "src" / "repro_torch"
TRAIN = "repro_torch.core.train"
TRACER = "repro_torch.tracing.tracer"


@pytest.fixture(autouse=True)
def _at_repo_root(monkeypatch):
    """Finding paths and baseline keys are relative to the repository
    root."""
    monkeypatch.chdir(REPO)


def _rel(path: Path) -> str:
    return path.relative_to(REPO).as_posix()


def lint_fixture(name: str, module=None, extra=()):
    """Lint one fixture (and ``extra`` (name, module) fixtures beside it);
    a fixture linted as ``module`` takes that module's pinned entries."""
    files = [(name, module), *extra]
    names = {_rel(FIXTURES / n): m for n, m in files if m}
    return lint_paths([FIXTURES / n for n, _ in files], module_names=names)


@pytest.fixture(scope="module")
def repo_findings():
    import os

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return lint_paths(["src/repro_torch"])
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def repo_graph():
    indexes = []
    for path in collect_files([PORT]):
        if path.suffix == ".py":
            indexes.append(ModuleIndex(_rel(path), module_name_for(path),
                                       ast.parse(path.read_text())))
    return indexes, build_graph(indexes)


# ---------------------------------------------------------------------------
# static rules: every rule catches its known-bad and passes its known-good
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule,bad,good,module", [
    ("R1", "r1_hot_bad.py", "r1_hot_good.py", TRAIN),
    ("R1", "r1_loop_bad.py", "r1_loop_good.py", TRAIN),
    ("R1", "r1_prefetch_bad.py", "r1_prefetch_good.py", TRAIN),
    ("R1", "r1_autograd_bad.py", "r1_autograd_good.py", None),
    ("R1", "r1_remat_bad.py", "r1_remat_good.py", TRAIN),
    ("R2", "r2_bad.py", "r2_good.py", None),
    ("R3", "r3_bad.py", "r3_good.py", None),
    ("R4", "r4_bad.py", "r4_good.py", None),
    ("R4", "r4_bad.cu", "r4_good.cu", None),
    ("R5", "r5_fallback_bad.py", "r5_fallback_good.py", None),
    ("R5", "r5_library_bad.py", "r5_library_good.py", None),
    ("R5", "r5_import_bad.py", "r5_import_good.py", None),
])
def test_rule_fixture_pair(rule, bad, good, module):
    found = lint_fixture(bad, module)
    assert rule in {f.rule for f in found}, f"{rule} missed {bad}"
    assert {f.rule for f in found} == {rule}, [f.render() for f in found]
    assert not lint_fixture(good, module), f"false positive in {good}"


def test_rule_ids_are_jax_ids():
    assert set(RULES) == set(jrules.RULES) == {"R1", "R2", "R3", "R4", "R5"}


def test_r1_hot_function_sites():
    """Each sync of the hot fixture is its own finding: a cast inside a
    hot callee, a tensor tested as a bool, np.asarray and .item()."""
    found = lint_fixture("r1_hot_bad.py", TRAIN)
    assert [(f.line, f.symbol) for f in found] == [
        (8, "_metrics"), (13, "train_step"), (15, "train_step"),
        (16, "train_step")]
    # the same file under another module name has no hot entry
    assert not lint_fixture("r1_hot_bad.py")


def test_r1_dispatch_loop_and_autograd_backward():
    loop = lint_fixture("r1_loop_bad.py", TRAIN)
    assert [f.symbol for f in loop] == ["fit"]
    assert "dispatch loop" in loop[0].message
    assert "train_step" in loop[0].message
    grad = lint_fixture("r1_autograd_bad.py")
    assert [f.symbol for f in grad] == ["Scale.backward"]


def test_r1_ingest_root_reached_from_a_hot_entry():
    stub = [("ingest_tracer.py", TRACER)]
    bad = lint_fixture("r1_ingest_bad.py", TRAIN, stub)
    assert len(bad) == 1 and bad[0].rule == "R1"
    assert "ingestion entry `trace_kernel`" in bad[0].message
    assert not lint_fixture("r1_ingest_good.py", TRAIN, stub)


def test_r2_r3_each_site():
    r2 = lint_fixture("r2_bad.py")
    assert {f.symbol for f in r2} == {"build_my_kernel", "jit_extension",
                                      "fused", "scripted"}
    assert len(r2) == 5
    r3 = lint_fixture("r3_bad.py")
    assert sum("global RNG" in f.message for f in r3) == 4
    assert sum("process-wide" in f.message for f in r3) == 1
    assert sum("hard-coded seed" in f.message for f in r3) == 2


def test_r4_cuda_float_atomics():
    found = lint_fixture("r4_bad.cu")
    assert [(f.line, f.symbol) for f in found] == [(7, "scatter_sum"),
                                                   (11, "bump")]
    assert all("float atomic" in f.message for f in found)


def test_r5_each_kind():
    fb = [f.message for f in lint_fixture("r5_fallback_bad.py")]
    assert sum("runs a plain version" in m for m in fb) == 1
    assert sum("carries on" in m for m in fb) == 1
    assert sum("picks the CPU" in m for m in fb) == 1
    assert sum("defaults" in m for m in fb) == 2
    lib = [f.message for f in lint_fixture("r5_library_bad.py")]
    assert sum("library kernel" in m for m in lib) == 3
    assert sum("bfloat16 cast" in m for m in lib) == 1
    imp = [f.message for f in lint_fixture("r5_import_bad.py")]
    assert len(imp) == 3 and all("import of" in m for m in imp)


# ---------------------------------------------------------------------------
# waivers
# ---------------------------------------------------------------------------


def test_waiver_comment_suppresses_rule(tmp_path):
    # r1_loop_good's waived loop is the SAME shape as r1_loop_bad's — only
    # the inline waiver separates them
    src = (FIXTURES / "r1_loop_good.py").read_text()
    bare = tmp_path / "r1_unwaived.py"
    bare.write_text("\n".join(line for line in src.splitlines()
                              if "lint: allow" not in line))
    found = lint_paths([bare], module_names={bare.as_posix(): TRAIN})
    assert [f.symbol for f in found] == ["waived_fit"]
    assert not lint_fixture("r1_loop_good.py", TRAIN)
    # a line waiver in a CUDA source
    cu = (FIXTURES / "r4_bad.cu").read_text().replace(
        "atomicAdd(&out[dst[i]], v[i]);",
        "atomicAdd(&out[dst[i]], v[i]);  // lint: allow[R4] a fixture")
    (tmp_path / "w.cu").write_text(cu)
    assert [f.symbol for f in lint_paths([tmp_path / "w.cu"])] == ["bump"]


def test_waiver_without_reason_is_a_finding(tmp_path):
    p = tmp_path / "w.py"
    p.write_text("import torch\n\n\ndef f(x):\n"
                 "    return torch.rand(3)  # lint: allow[R3]\n")
    found = lint_paths([p])
    assert [(f.rule, f.line, f.symbol) for f in found] == [
        ("R3", 5, "<waiver>")]
    assert "without a reason" in found[0].message


def test_every_port_waiver_gives_a_reason():
    waivers = 0
    for path in collect_files([PORT]):
        src = path.read_text()
        cuda = path.suffix != ".py"
        waivers += src.count("lint: allow[")
        assert not unexplained_waivers(_rel(path), src, cuda=cuda)
    assert waivers >= 10


# ---------------------------------------------------------------------------
# the hot call graph
# ---------------------------------------------------------------------------


def test_pinned_entries_are_hot(repo_graph):
    indexes, funcs = repo_graph
    for fid in HOT_ENTRIES:
        assert fid in funcs, f"pinned hot entry {fid} not found"
        assert funcs[fid].hot_entry and funcs[fid].hot
    # every torch.autograd.Function's forward / backward, by base class
    classes = {(f.path, f.cls) for f in funcs.values() if f.autograd}
    assert classes == {
        ("src/repro_torch/kernels/rgcn_fused/ops.py", "_FusedAggFlat"),
        ("src/repro_torch/kernels/rgcn_spmm/ops.py", "_MessageAggFlat"),
        ("src/repro_torch/kernels/rgcn_spmm/ops.py", "_MessageAgg"),
        ("src/repro_torch/kernels/flash_attention/ops.py",
         "_FlashAttention"),
        ("src/repro_torch/kernels/ssd_scan/ops.py", "_SSDIntraChunk"),
        ("src/repro_torch/models/layers.py", "_TakeRows"),
        ("src/repro_torch/models/moe.py", "_Dispatch"),
        ("src/repro_torch/models/moe.py", "_Combine"),
        ("src/repro_torch/distributed/group.py", "_GatherRows"),
        ("src/repro_torch/distributed/model_parallel.py", "_Gather"),
        ("src/repro_torch/distributed/model_parallel.py", "_CopyIn"),
        ("src/repro_torch/distributed/model_parallel.py", "_SumOut"),
    }
    assert sum(f.autograd for f in funcs.values()) == 24
    # the fit's step loop: its callees run every step
    (loop,) = DISPATCH_LOOPS
    assert funcs[loop].dispatch_loop and not funcs[loop].hot
    assert funcs["repro_torch.core.train:draw_step"].hot
    assert funcs["repro_torch.core.train:ContrastiveTrainer._fit_steps."
                 "flush"].hot
    # reached through calls: the encoder, the kernel wrappers, the sweep
    for fid in ("repro_torch.core.rgcn:encode_packed",
                "repro_torch.kernels.rgcn_fused.ops:rgcn_fused_agg_flat",
                "repro_torch.core.clustering:sweep_cluster_stack",
                "repro_torch.kernels.kmeans_assign.ops:silhouette_sums",
                "repro_torch.models.moe:moe_forward",
                "repro_torch.optim.adamw:apply_gradients",
                "repro_torch.kernels:launch"):
        assert funcs[fid].hot, fid
    # the factory of the LM step hands out a hot function
    assert funcs["repro_torch.launch.steps:make_train_step"].returns_hot
    # host-only roots stay off the hot set
    for fid in INGEST_ENTRIES:
        assert fid in funcs and funcs[fid].host_entry
        assert not funcs[fid].hot, f"{fid} must stay host-side"
    # the pool hop is a call edge: iter_graphs -> _build_one via submit
    it = funcs["repro_torch.ingest.engine:IngestEngine.iter_graphs"]
    assert "repro_torch.ingest.engine:IngestEngine._build_one" in it.calls


# ---------------------------------------------------------------------------
# repo-wide run vs the checked-in baseline
# ---------------------------------------------------------------------------


def test_repo_run_matches_baseline_exactly(repo_findings):
    baseline = load_baseline(BASELINE_PATH)
    new, accepted, stale = diff_baseline(repo_findings, baseline)
    assert not new, "new lint findings:\n" + "\n".join(
        f.render() for f in new)
    assert not stale, "stale baseline entries (fixed? remove them):\n" \
        + "\n".join(stale)
    assert len(accepted) == sum(baseline.values())
    assert Counter(f.key for f in repo_findings) == baseline
    # the accepted findings are host syncs and order-dependent sums only
    assert {f.rule for f in repo_findings} <= {"R1", "R4"}


def test_baseline_diff_detects_new_and_stale():
    findings = lint_fixture("r3_bad.py")
    assert findings
    baseline = load_baseline(BASELINE_PATH)   # port keys: all stale here
    new, accepted, stale = diff_baseline(findings, baseline)
    assert len(new) == len(findings) and not accepted
    assert set(stale) == set(baseline)
    # one accepted, a second instance of the same key new, a fixed one stale
    key = findings[0].key
    twice = findings + [findings[0]]
    new, accepted, stale = diff_baseline(
        twice, Counter({key: 1, "R9 :: gone": 1}))
    assert [f.key for f in accepted] == [key]
    assert len(new) == len(findings)
    assert stale == ["R9 :: gone"]


def test_cli_json_and_exit_codes(capsys, tmp_path):
    bad = _rel(FIXTURES / "r4_bad.py")
    assert main(["--json", "--no-baseline", bad]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["summary"] == {"total": 5, "new": 5, "baselined": 0,
                              "stale": 0}
    assert set(doc["findings"][0]) == {"rule", "path", "line", "col",
                                       "symbol", "message", "key",
                                       "baselined"}
    assert {f["rule"] for f in doc["findings"]} == {"R4"}
    assert main(["--no-baseline", _rel(FIXTURES / "r4_good.py")]) == 0
    capsys.readouterr()
    # accept the findings, then the check passes; the port's own baseline
    # against a fixture is all stale and fails
    path = tmp_path / "baseline.json"
    assert main(["--write-baseline", "--baseline", str(path), bad]) == 0
    assert main(["--check-baseline", "--baseline", str(path), bad]) == 0
    assert main(["--check-baseline", bad]) == 1
    out = capsys.readouterr().out
    assert "stale baseline entry" in out


def test_cli_default_scan_is_the_port(capsys, monkeypatch, repo_findings):
    seen = []
    monkeypatch.setattr("repro_torch.analysis.lint.lint_paths",
                        lambda paths: seen.append(paths) or repo_findings)
    assert main(["--check-baseline"]) == 0
    assert seen == [["src/repro_torch"]]
    assert "0 new, 0 stale" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# held against JAX's linter on the same inputs
# ---------------------------------------------------------------------------


_WAIVER_SOURCES = [
    "x = 1  # lint: allow[R1] reason\n",
    "# lint: allow[R1, R3] two rules\ny = f()\n",
    "def f():  # lint: allow[ALL] everything\n    pass\n",
    "s = '# lint: allow[R2] inside a string'\n",
    "z = (1,\n",                                 # a tokenize error
    "#lint:allow[R4]\n# lint: allow[R5]   spaced\n",
]


def test_parse_waivers_matches_jax():
    sources = _WAIVER_SOURCES + [
        p.read_text() for p in sorted(FIXTURES.glob("*.py"))] + [
        p.read_text() for p in collect_files([PORT]) if p.suffix == ".py"]
    for src in sources:
        assert parse_waivers(src) == jrules.parse_waivers(src)


def test_finding_key_and_render_match_jax(repo_findings):
    findings = repo_findings + lint_fixture("r1_hot_bad.py", TRAIN) \
        + lint_fixture("r4_bad.cu")
    for f in findings:
        j = jrules.Finding(f.rule, f.path, f.line, f.col, f.symbol,
                           f.message)
        assert (f.key, f.render()) == (j.key, j.render())
        assert set(Finding.__dataclass_fields__) == set(
            jrules.Finding.__dataclass_fields__)


def test_module_name_for_matches_jax():
    for p in ["src/repro_torch/core/train.py",
              "src/repro_torch/kernels/__init__.py",
              "src/repro/analysis/lint.py", "tests/fixtures/lint/r1_bad.py",
              "examples/quickstart_torch.py", "__init__.py"]:
        for root in (None, Path("tests")):
            assert module_name_for(Path(p), root) == \
                jlint.module_name_for(Path(p), root)


def test_diff_baseline_matches_jax(repo_findings):
    findings = repo_findings + lint_fixture("r3_bad.py")
    jfindings = [jrules.Finding(f.rule, f.path, f.line, f.col, f.symbol,
                                f.message) for f in findings]
    keys = [f.key for f in findings]
    for baseline in (Counter(), load_baseline(BASELINE_PATH),
                     Counter({keys[0]: 2, keys[-1]: 1, "R1 :: gone": 3})):
        new, acc, stale = diff_baseline(findings, baseline)
        jnew, jacc, jstale = jlint.diff_baseline(jfindings, baseline)
        assert [f.key for f in new] == [f.key for f in jnew]
        assert [f.key for f in acc] == [f.key for f in jacc]
        assert stale == jstale


def test_write_baseline_matches_jax(tmp_path, repo_findings):
    write_baseline(tmp_path / "port.json", repo_findings)
    jlint.write_baseline(tmp_path / "jax.json", [
        jrules.Finding(f.rule, f.path, f.line, f.col, f.symbol, f.message)
        for f in repo_findings])
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert load_baseline(tmp_path / "port.json") == \
        jlint.load_baseline(tmp_path / "jax.json")
