"""The port's whole fit against the JAX package's, on JAX's draws (CPU).

The port's own fit draws its initial parameters and every step's
augmentations, feature noise and dropout from ``torch.Generator``s, so its
encoder, and the K the grid picks with it, differ from JAX's.  Here the
port's ``ContrastiveTrainer.fit`` runs with JAX's draws instead: the
initial parameters from ``init_rgcn(split(PRNGKey(seed))[1])`` and step
i's draws from ``fold_in(base_key, i)`` (``_jax_draws`` of
``test_torch_train.py``), on nw's training graphs, at the default widths
and optimizer, against the JAX trainer's own fit.

The test runs the first ``STEPS`` steps (~30 s alone on one worker);
the parameters are held as one vector, relative to its norm, within
``PARAM_TOL`` (two autodiff systems sum the backward in different orders,
and Adam divides by sqrt(v), which magnifies that noise where a gradient
is small; see ``test_three_steps_match_jax_engine``).  The whole default
fit (120 steps) and the K that both encoders give on the 11 paper programs
is a one-off:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fit_parity.py
"""

import contextlib
import itertools
import json
import sys
from pathlib import Path

import jax
import numpy as np

from repro.core.rgcn import RGCNConfig as JRGCNConfig
from repro.core.rgcn import init_rgcn as jax_init_rgcn
from repro.core.sampler import GCLSampler as JGCLSampler
from repro.core.train import ContrastiveTrainer as JTrainer
from repro.core.train import GCLTrainConfig as JGCLTrainConfig
from repro.sampling.store import flatten_tree
from repro.tracing.programs import get_program
from repro_torch.core import rgcn as rgcn_mod
from repro_torch.core import train as train_mod
from repro_torch.core.rgcn import RGCNConfig
from repro_torch.core.train import ContrastiveTrainer, GCLTrainConfig
from repro_torch.interop import params_from_jax, params_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_train import _jax_draws  # noqa: E402

#: steps of the tier-1 comparison and its tolerances: the parameters (see
#: the docstring) and every step's training loss, relative (the losses of
#: the first steps differ by ~1e-6; validation draws differ and are not
#: compared)
STEPS = 16
PARAM_TOL = 1e-4
LOSS_TOL = 1e-5
JRC = JRGCNConfig()


def nw_training_graphs():
    """The graphs ``GCLSampler.train`` fits on for nw (255 < the 400-graph
    subsample, so all of them)."""
    graphs = JGCLSampler().build_graphs(get_program("nw"))
    assert len(graphs) <= JGCLSampler().cfg.train_subsample
    return graphs


@contextlib.contextmanager
def on_jax_draws(seed=0):
    """Make the port's fit take JAX's initial parameters and JAX's per-step
    training draws (validation keeps the port's: it moves no parameter)."""
    base_key, k_init = jax.random.split(jax.random.PRNGKey(seed))
    jparams = flatten_tree(jax_init_rgcn(k_init, JRC))
    steps = itertools.count()
    init, draw = rgcn_mod.init_rgcn, train_mod.draw_step

    def jax_init(_seed, rc):
        return params_from_jax(jparams, rc)

    def jax_step_draws(gen, batch, rc, *, train=True):
        if not train:
            return draw(gen, batch, rc, train=False)
        return _jax_draws(jax.random.fold_in(base_key, next(steps)), batch,
                          JRC)

    rgcn_mod.init_rgcn, train_mod.draw_step = jax_init, jax_step_draws
    try:
        yield
    finally:
        rgcn_mod.init_rgcn, train_mod.draw_step = init, draw


def fits(graphs, steps):
    """(port params on JAX's draws, JAX params, port info, JAX info), the
    parameters as flat numpy dicts in JAX's layout."""
    with on_jax_draws():
        enc, info = ContrastiveTrainer(RGCNConfig(),
                                       GCLTrainConfig(steps=steps),
                                       device="cpu").fit(graphs)
    jparams, jinfo = JTrainer(JRC, JGCLTrainConfig(steps=steps)).fit(graphs)
    return params_to_numpy(enc), flatten_tree(jparams), info, jinfo


def gaps(got, want):
    """(whole-vector gap relative to its norm, {leaf: the same per leaf})."""
    per = {k: float(np.linalg.norm(got[k] - want[k])
                    / max(np.linalg.norm(want[k]), 1e-30)) for k in want}
    diff = np.sqrt(sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want))
    norm = np.sqrt(sum(float(np.sum(want[k] ** 2)) for k in want))
    return diff / norm, per


def test_fit_on_jax_draws_matches_jax_fit():
    got, want, info, jinfo = fits(nw_training_graphs(), STEPS)
    assert sorted(got) == sorted(want)
    whole, per = gaps(got, want)
    assert whole <= PARAM_TOL, (whole, per)
    loss = np.array([h["loss"] for h in info["history"]])
    jloss = np.array([h["loss"] for h in jinfo["history"]])
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL)


def _k_by_program(params):
    """K of the port's gcl plan for each paper program, with ``params``
    (JAX layout) adopted as the encoder trained on nw (CPU)."""
    from repro_torch.sampling import Artifacts, get_method
    from repro_torch.tracing.programs import PAPER_PROGRAMS
    from repro_torch.tracing.programs import get_program as port_program

    method = get_method("gcl", device="cpu")
    method.adopt(Artifacts("gcl", "nw", "fit", payload={"params": params},
                           meta={"trained_on": "nw"}))
    return {name: method.run(port_program(name))[0].num_clusters
            for name in PAPER_PROGRAMS}


def main(steps=120):
    graphs = nw_training_graphs()
    got, want, info, jinfo = fits(graphs, steps)
    whole, per = gaps(got, want)
    print(f"[fit] nw, {len(graphs)} graphs, {steps} steps on JAX's draws: "
          f"parameters {whole:.3e} of their norm from JAX's fit; val_loss "
          f"port {info['val_loss']!r} JAX {jinfo['val_loss']!r}")
    for k, v in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"[fit]   {k}: {v:.3e}")
    # where the two fits part: the per-step training loss, relative
    loss = np.array([h["loss"] for h in info["history"]])
    jloss = np.array([h["loss"] for h in jinfo["history"]])
    gap = np.abs(loss - jloss) / np.abs(jloss)
    for tol in (1e-6, 1e-5, 1e-4, 1e-3):
        first = np.flatnonzero(gap > tol)
        print(f"[fit] first step whose loss differs by more than {tol:.0e}: "
              f"{int(first[0]) if first.size else 'none'}")
    print("[fit] loss gap every 10 steps: " + " ".join(
        f"{i}:{gap[i]:.1e}" for i in range(0, len(gap), 10)))
    ref = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
        / "assets" / "reference_grid.json"
    with open(ref) as f:
        grid_k = {r["program"]: r["k"] for r in json.load(f)["grid"]
                  if r["method_id"] == "gcl"}
    k_port, k_jax = _k_by_program(got), _k_by_program(want)
    same = sum(k_port[p] == k_jax[p] for p in k_jax)
    print(f"[K] program: port fit on JAX's draws / JAX's fit (both "
          f"clustered by the port) / JAX's grid fixture")
    for p in k_jax:
        print(f"[K]   {p}: {k_port[p]} / {k_jax[p]} / {grid_k.get(p)}")
    print(f"[K] equal on {same} of {len(k_jax)} programs")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 120)
