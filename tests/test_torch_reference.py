"""The committed JAX reference fixture for the PyTorch port.

``src/repro_torch/assets/reference_phi2.npz`` holds an encoder trained by
the JAX package (``get_method("gcl", steps=60, seed=0)`` fit on ``phi-2``)
and what the JAX pipeline made of ``phi-2`` and ``cfd`` with it: the
embeddings of each program's distinct graphs with the index map back to
its invocations, K, labels, the per-K silhouette scores, representatives,
and eq. 5 / eq. 6 on P1.  ``chip_smoke.py`` holds the port on the card
against it.

Regenerate (JAX on the CPU, a few minutes)::

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
PROGRAMS = ("phi-2", "cfd")


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
    for name in PROGRAMS:
        print(name, "K", int(ref[f"{name}:k"]),
              "reps", ref[f"{name}:reps"].tolist(),
              "eq5 %", float(ref[f"{name}:error_cycles"]),
              "eq6", float(ref[f"{name}:speedup"]))
    print("wrote", os.path.abspath(FIXTURE),
          os.path.getsize(FIXTURE), "bytes")
