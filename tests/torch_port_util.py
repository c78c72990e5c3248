"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Each parity test draws a random numpy parameter tree in the shape of a JAX
module's variables (:func:`random_tree`: no zero-initialised heads or all-ones
norm scales, so every parameter carries information), carries it into the
port module with ``load_jax_params`` and runs both sides on the same numpy
inputs in float32. The tree's shapes come from ``jax.eval_shape`` of the
module's ``init``, which costs a fraction of running the initialisers.
jax is imported where a helper needs it, so that the tests that run on a CUDA
card without it (tests/test_torch_cuda.py) can take :func:`emulated_key_loop`
from here.
"""

import dataclasses

import numpy as np
import torch

from reptext_tpu_torch import configs as port_configs
from reptext_tpu_torch.io.from_jax import load_jax_params

# the default parity tolerance (tests/test_torch_parity_model.py:331)
TOL = dict(rtol=5e-4, atol=5e-4)


def np_tree(variables):
    import jax

    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), variables)


def random_tree(module, *args, seed=0, **kwargs):
    """Random float32 numpy variables for ``module.init(key, *args, **kwargs)``.

    Kernels N(0, 1/fan_in) (Dense [.., in, out], Conv [kh, kw, in, out]),
    embeddings N(0, 0.5), norm scales 1 + N(0, 0.05), biases N(0, 0.05).
    """
    import jax

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


LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def emulated_key_loop(qp, kp, v, logit_mul, online, tile=128, state=None, first=True,
                      last=True, carry=False, clamp=43.0):
    """The forward kernel's key loop (``csrc/flash_attention.cu``) in plain
    PyTorch, tile by tile, on q' and k' as the kernel stages them (rotated,
    scaled and rounded already): fp32 logits of one ``tile`` of keys, taken to
    log2 units by one multiply with ``logit_mul`` (log2(e), times 1/sqrt(D)
    where q' does not carry it), clamped at ``clamp`` * log2(e) or kept
    against a running max, exponentiated with ``exp2``, rounded to v's dtype
    for PV, accumulated in fp32; a last tile shorter than ``tile`` stands for
    the masked keys past the end. Returns (out, lse) in natural units, or,
    with ``carry`` (the ring step), the state (acc, m, l) with m in natural
    units unless ``last``, when it returns out alone; ``state`` and ``first``
    as in ``ring_step``. tests/test_torch_cuda.py holds the kernel itself
    against this loop, closer than against its plain version.
    """
    shape, f32 = qp.shape[:-1], dict(dtype=torch.float32, device=qp.device)
    if state is None or first:
        acc = torch.zeros(qp.shape, **f32)
        l = torch.zeros(shape, **f32)
        m = torch.full(shape, -1e30 * LOG2E if carry else -float("inf"), **f32)
    else:
        acc, m, l = state[0].clone(), state[1] * LOG2E, state[2].clone()
    qf = qp.float()
    mul = torch.tensor(logit_mul, **f32)
    for k0 in range(0, kp.shape[2], tile):
        s = torch.matmul(qf, kp[:, :, k0:k0 + tile].float().transpose(-1, -2))
        if online:
            m_new = torch.maximum(m, s.amax(dim=-1) * mul)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * mul - m_new[..., None])
            l, acc, m = l * alpha, acc * alpha[..., None], m_new
        else:
            p = torch.exp2((s * mul).clamp(-clamp * LOG2E, clamp * LOG2E))
        l = l + p.sum(dim=-1)
        acc = acc + torch.matmul(p.to(v.dtype).float(), v[:, :, k0:k0 + tile].float())
    if carry and not last:
        return acc, m * LN2, l
    out = (acc / l[..., None]).to(qp.dtype)
    if carry:
        return out
    return out, (m * LN2 if online else 0.0) + torch.log(l)
