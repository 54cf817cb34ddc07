"""The committed JAX reference fixture for the PyTorch port.

``src/repro_torch/assets/reference_phi2.npz`` holds an encoder trained by
the JAX package (``get_method("gcl", steps=60, seed=0)`` fit on ``phi-2``)
and what the JAX pipeline made of ``phi-2`` and ``cfd`` with it: the
embeddings of each program's distinct graphs with the index map back to
its invocations, K, labels, the per-K silhouette scores, representatives,
and eq. 5 / eq. 6 on P1.  ``chip_smoke.py`` holds the port on the card
against it.

A second file, ``src/repro_torch/assets/reference_grid.json``, holds what
the card cannot compute without JAX: the JAX sequential reference
(``select_k_and_cluster``) on the fixture's phi-2 and cfd embeddings (K,
labels, per-K scores, representatives), and the JAX comparison grid
(``run_grid`` over the 11 paper programs on P1-P3): K, representatives,
eq. 5 and eq. 6 of every pka / sieve / stem_root row, and the gcl rows at
the default config for a side-by-side print.

Regenerate both (JAX on the CPU, ~15 minutes)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_reference.py --write

The tests below re-embed the stored distinct graphs from the stored params,
once with the JAX package (it must reproduce its own arrays, 1e-6) and once
with the port's plain path on the CPU (1e-5 relative).
"""

import os
import sys

import numpy as np
import pytest

FIXTURE = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                       "repro_torch", "assets", "reference_phi2.npz")
GRID_FIXTURE = os.path.join(os.path.dirname(FIXTURE), "reference_grid.json")
PROGRAMS = ("phi-2", "cfd")
PLATFORMS = ("P1", "P2", "P3")


def write_fixture(path: str = FIXTURE) -> dict:
    """Fit the JAX gcl method on phi-2, plan phi-2 and cfd, store it all."""
    from repro.core.batching import graph_content_hash
    from repro.sampling import evaluate, get_method
    from repro.sampling.store import flatten_tree
    from repro.tracing.programs import get_program

    method = get_method("gcl", steps=60, seed=0)
    out: dict = {}
    for name in PROGRAMS:
        prog = get_program(name)
        art = method.prepare(prog)
        plan = method.plan(prog, art)
        ev = evaluate(plan, prog, "P1")
        emb = np.asarray(art.payload["embeddings"], np.float32)
        hashes = [graph_content_hash(g)
                  for g in method.sampler.iter_graphs(prog)]
        first: dict = {}
        for i, h in enumerate(hashes):
            first.setdefault(h, i)
        order = list(first)
        index = np.array([order.index(h) for h in hashes], np.int32)
        distinct = emb[[first[h] for h in order]]
        assert np.array_equal(distinct[index], emb)
        scores = plan.extra.get("scores", {})
        out.update({
            f"{name}:emb_distinct": distinct,
            f"{name}:index": index,
            f"{name}:k": np.int32(plan.num_clusters),
            f"{name}:labels": np.asarray(plan.labels, np.int32),
            f"{name}:scores_k": np.array(sorted(scores), np.int32),
            f"{name}:scores": np.array([scores[k] for k in sorted(scores)],
                                       np.float64),
            f"{name}:reps": np.array(plan.rep_indices(), np.int32),
            f"{name}:error_cycles": np.float64(ev.error_pct["cycles"]),
            f"{name}:speedup": np.float64(ev.speedup),
        })
    for key, arr in flatten_tree(method.sampler.params).items():
        out[f"param:{key}"] = np.asarray(arr, np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def fixture_embeddings(ref: dict, name: str):
    """A program's per-invocation embeddings from the fixture."""
    return ref[f"{name}:emb_distinct"][ref[f"{name}:index"]]


def exact_silhouette(x, labels) -> float:
    """Float64 mean silhouette (clusters of one contribute 0), distances
    from the Gram matrix (no (n, n, d) intermediate)."""
    x = np.asarray(x, np.float64)
    lab = np.asarray(labels)
    g = x @ x.T
    sq = np.diag(g)
    d = np.sqrt(np.maximum(sq[:, None] - 2 * g + sq[None, :], 0.0))
    np.fill_diagonal(d, 0.0)
    ks = np.unique(lab)
    onehot = (lab[:, None] == ks[None, :]).astype(np.float64)
    cnt = onehot.sum(0)
    sums = d @ onehot
    own = np.searchsorted(ks, lab)
    own_cnt = cnt[own]
    a = sums[np.arange(len(x)), own] / np.maximum(own_cnt - 1, 1)
    mean = sums / cnt[None, :]
    mean[np.arange(len(x)), own] = np.inf
    b = mean.min(1)
    s = np.where(own_cnt > 1, (b - a) / np.maximum(np.maximum(a, b), 1e-12),
                 0.0)
    return float(s.mean())


def _exact_scores(x, seed=0, k_max=48, sil_cap=1200):
    """Exact float64 silhouettes of the JAX sequential path's per-K labels
    (the same fits, subsample and relabelling as
    ``select_k_and_cluster``): what its float32 scores approximate."""
    from repro.core.clustering import kmeans

    n = len(x)
    idx = (np.random.default_rng(seed).choice(n, sil_cap, replace=False)
           if n > sil_cap else np.arange(n))
    out = {}
    for k in range(2, min(k_max, n - 1) + 1):
        _, lab = np.unique(kmeans(x, k, seed=seed)[0], return_inverse=True)
        if lab.max() == 0 or lab[idx].max() == lab[idx].min():
            continue
        out[str(k)] = exact_silhouette(x[idx], lab[idx])
    return out


def write_grid_fixture(path: str = GRID_FIXTURE) -> dict:
    """Record the JAX sequential reference on the fixture embeddings and
    the JAX comparison grid (11 paper programs x P1-P3) as JSON."""
    import json
    import tempfile

    from repro.core.clustering import select_k_and_cluster
    from repro.launch.sample import run_grid
    from repro.sampling import ArtifactStore, plan_from_labels
    from repro.tracing.programs import PAPER_PROGRAMS, get_program

    ref = _load()
    out: dict = {"sequential": {}, "grid": []}
    for name in PROGRAMS:
        x = fixture_embeddings(ref, name)
        labels, info = select_k_and_cluster(x)
        seqs = np.array([k.seq for k in get_program(name).kernels])
        plan = plan_from_labels(labels, seqs, "x")
        scores = info.get("scores", {})
        out["sequential"][name] = {
            "k": int(info["k"]), "mode": info["mode"],
            "labels": [int(v) for v in labels],
            "scores": {str(k): float(v) for k, v in sorted(scores.items())},
            "scores_exact": _exact_scores(x),
            "reps": [int(r) for r in plan.rep_indices()]}
    with tempfile.TemporaryDirectory() as tmp:
        doc = run_grid(["gcl", "pka", "sieve", "stem_root"],
                       list(PAPER_PROGRAMS), list(PLATFORMS), tmp,
                       verbose=False)
        store = ArtifactStore(os.path.join(tmp, "artifacts"))
        for row in doc["results"]:
            plan = store.load_plan(row["method_id"], row["artifact_key"])
            out["grid"].append({
                "method_id": row["method_id"], "program": row["program"],
                "platform": row["platform"], "k": row["num_clusters"],
                "reps": [int(r) for r in plan.rep_indices()],
                "eq5": row["error_pct"]["cycles"], "eq6": row["speedup"]})
    assert not doc["failures"] and not doc["batch_plan_errors"], doc
    with open(path, "w") as f:
        json.dump(out, f, sort_keys=True, separators=(",", ":"))
    return out


def _load():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _distinct_graphs(name):
    """The program's distinct graphs in first-appearance order (the order
    the fixture's ``emb_distinct`` rows follow)."""
    from repro.core.batching import graph_content_hash
    from repro.core.graphs import iter_kernel_graphs
    from repro.tracing.programs import get_program

    seen: dict = {}
    for g in iter_kernel_graphs(get_program(name)):
        seen.setdefault(graph_content_hash(g), g)
    return list(seen.values())


@pytest.mark.parametrize("name", PROGRAMS)
def test_fixture_reembeds_with_jax(name):
    """The JAX package re-embeds the stored distinct graphs from the stored
    params to within 1e-6 of the stored embeddings, and the stored plan is
    self-consistent (K clusters, one representative each)."""
    from repro.core.rgcn import RGCNConfig
    from repro.core.train import ContrastiveTrainer, GCLTrainConfig
    from repro.sampling.store import unflatten_tree

    ref = _load()
    params = unflatten_tree({k[len("param:"):]: v for k, v in ref.items()
                             if k.startswith("param:")})
    trainer = ContrastiveTrainer(RGCNConfig(), GCLTrainConfig())
    z = trainer.embed(params, _distinct_graphs(name))
    want = ref[f"{name}:emb_distinct"]
    np.testing.assert_allclose(z, want, rtol=1e-6, atol=1e-6)
    labels = ref[f"{name}:labels"]
    assert len(labels) == len(ref[f"{name}:index"])
    assert int(labels.max()) + 1 == int(ref[f"{name}:k"])
    assert len(ref[f"{name}:reps"]) == int(ref[f"{name}:k"])


@pytest.mark.parametrize("name", PROGRAMS)
def test_fixture_reembeds_with_port(name):
    """The port's plain path on the CPU embeds the same distinct graphs from
    the same params to within 1e-5 of the JAX embeddings (relative to the
    largest magnitude)."""
    from repro_torch.core.rgcn import RGCNConfig as TRGCNConfig
    from repro_torch.core.train import ContrastiveTrainer as TTrainer
    from repro_torch.interop import params_from_jax
    from repro_torch.tracing.programs import get_program as tget_program
    from repro_torch.core.graphs import iter_kernel_graphs as titer

    ref = _load()
    enc = params_from_jax({k[len("param:"):]: v for k, v in ref.items()
                           if k.startswith("param:")})
    seen: dict = {}
    from repro_torch.core.batching import graph_content_hash as thash
    for g in titer(tget_program(name)):
        seen.setdefault(thash(g), g)
    trainer = TTrainer(TRGCNConfig(), device="cpu")
    z = trainer.embed(enc, list(seen.values()))
    want = ref[f"{name}:emb_distinct"]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(z, want, rtol=1e-5, atol=1e-5 * scale)


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_reference.py --write")
    ref = write_fixture()
    grid = write_grid_fixture()
    print("sequential K", {k: v["k"] for k, v in grid["sequential"].items()},
          "grid rows", len(grid["grid"]), "->", os.path.abspath(GRID_FIXTURE))
    for name in PROGRAMS:
        print(name, "K", int(ref[f"{name}:k"]),
              "reps", ref[f"{name}:reps"].tolist(),
              "eq5 %", float(ref[f"{name}:error_cycles"]),
              "eq6", float(ref[f"{name}:speedup"]))
    print("wrote", os.path.abspath(FIXTURE),
          os.path.getsize(FIXTURE), "bytes")
