"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Each parity test draws a random numpy parameter tree in the shape of a JAX
module's variables (:func:`random_tree`: no zero-initialised heads or all-ones
norm scales, so every parameter carries information), carries it into the
port module with ``load_jax_params`` and runs both sides on the same numpy
inputs in float32. The tree's shapes come from ``jax.eval_shape`` of the
module's ``init``, which costs a fraction of running the initialisers.
"""

import dataclasses

import jax
import numpy as np
import torch

from reptext_tpu_torch import configs as port_configs
from reptext_tpu_torch.io.from_jax import load_jax_params

# the default parity tolerance (tests/test_torch_parity_model.py:331)
TOL = dict(rtol=5e-4, atol=5e-4)


def np_tree(variables):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), variables)


def random_tree(module, *args, seed=0, **kwargs):
    """Random float32 numpy variables for ``module.init(key, *args, **kwargs)``.

    Kernels N(0, 1/fan_in) (Dense [.., in, out], Conv [kh, kw, in, out]),
    embeddings N(0, 0.5), norm scales 1 + N(0, 0.05), biases N(0, 0.05).
    """
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    r = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-2]
            x = r.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "embedding":
            x = 0.5 * r.standard_normal(shape)
        elif name in ("scale", "weight"):
            x = 1.0 + 0.05 * r.standard_normal(shape)
        else:
            x = 0.05 * r.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def carried(module: torch.nn.Module, tree) -> torch.nn.Module:
    return load_jax_params(module, tree).eval()


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def port_config(cfg):
    """The port's config dataclass of the same name with ``cfg``'s fields, so
    that the port never sees the JAX package's class."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(port_configs, type(cfg).__name__)(**fields)


def port_configs_of(cfgs):
    """``{name: port_config(cfg)}`` for a dict of JAX configs."""
    return {k: port_config(v) for k, v in cfgs.items()}
