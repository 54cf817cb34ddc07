"""Known-bad R5: the port imports the JAX side."""
import jax.numpy as jnp

import repro
from repro.core import rgcn


def encode(x):
    return rgcn.encode(jnp.asarray(x)), repro.__name__
