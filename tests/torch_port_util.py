"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Each parity test draws a random numpy parameter tree in the shape of a JAX
module's variables (:func:`random_tree`: no zero-initialised heads or all-ones
norm scales, so every parameter carries information), carries it into the
port module with ``load_jax_params`` and runs both sides on the same numpy
inputs in float32. The tree's shapes come from ``jax.eval_shape`` of the
module's ``init``, which costs a fraction of running the initialisers.
jax is imported where a helper needs it, so that the tests that run on a CUDA
card without it (tests/test_torch_cuda.py) can take :func:`emulated_key_loop`
and :func:`emulated_backward_loop` from here. The tokenizer fixtures of
``tests/test_tokenizers.py`` (``_tiny_clip_files``, ``_serialize_model_proto``,
``TINY_PIECES``) are copied here for the port's tests, from the port's own
writers (``reptext_tpu_torch/io/synthetic.py``).
"""

import dataclasses

import numpy as np
import torch

from reptext_tpu_torch import configs as port_configs
from reptext_tpu_torch.io.from_jax import load_jax_params
from reptext_tpu_torch.io.synthetic import serialize_model_proto, write_clip_tokenizer
from reptext_tpu_torch.text.spm import CONTROL, NORMAL, UNKNOWN

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


def tiny_clip_files(path):
    """vocab.json + merges.txt of ``tests/test_tokenizers.py::_tiny_clip_files``
    (the byte alphabet, its end-of-word forms, nine merges building "hello",
    "world" and "12", the two special tokens) into ``path``; returns it."""
    write_clip_tokenizer(str(path))
    return path


# ``tests/test_tokenizers.py::TINY_PIECES``
TINY_PIECES = [
    ("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL), ("<unk>", 0.0, UNKNOWN),
    ("▁", -4.0, NORMAL), ("▁hello", -1.5, NORMAL), ("▁world", -1.8, NORMAL),
    ("▁he", -3.0, NORMAL), ("llo", -3.5, NORMAL), ("w", -5.0, NORMAL), ("o", -5.1, NORMAL),
    ("r", -5.2, NORMAL), ("l", -5.3, NORMAL), ("d", -5.4, NORMAL), ("h", -5.5, NORMAL),
    ("e", -5.6, NORMAL), ("▁a", -2.5, NORMAL), ("b", -5.7, NORMAL), ("a", -5.8, NORMAL),
]


def write_tokenizer_dirs(root, pieces=TINY_PIECES):
    """``root/tokenizer`` (:func:`tiny_clip_files`) and
    ``root/tokenizer_2/spiece.model`` (``pieces``), as a converted checkpoint
    holds them; returns root."""
    (root / "tokenizer").mkdir(parents=True, exist_ok=True)
    tiny_clip_files(root / "tokenizer")
    (root / "tokenizer_2").mkdir(exist_ok=True)
    (root / "tokenizer_2" / "spiece.model").write_bytes(serialize_model_proto(pieces))
    return root


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


def emulated_backward_loop(q, k, v, out, lse, do, online, key_tile=128, query_tile=64,
                           clamp=43.0):
    """The backward kernel's loops (``csrc/flash_attention_bwd.cu``) in plain
    PyTorch: the preprocess pass (delta = sum(dO * O), lse * log2(e)); then a
    block of ``key_tile`` keys owned at a time, the queries streamed past it
    in tiles of ``query_tile``: transposed fp32 logits k q^T taken to log2
    units by one multiply with log2(e) / sqrt(D), clamped at ``clamp`` *
    log2(e) unless ``online``, p^T = exp2(. - lse log2(e)), ds^T = p^T (v
    dO^T - delta), both rounded to q's dtype for their products, dk and dv
    accumulated in fp32 across the query tiles, the block's partial dq added
    into an fp32 buffer across the key blocks; the scale and the rounding to
    q's dtype at the end. A last tile shorter than its size stands for the
    masked rows past the end. tests/test_torch_cuda.py holds the kernel itself
    against this loop, closer than against its plain version.
    """
    f32 = dict(dtype=torch.float32, device=q.device)
    s_len, d = q.shape[2], q.shape[3]
    scale = 1.0 / float(np.sqrt(d))
    mul = torch.tensor(scale * LOG2E, **f32)
    delta = (do.float() * out.float()).sum(dim=-1)
    lse2 = lse * torch.tensor(LOG2E, **f32)
    dq_acc = torch.zeros(q.shape, **f32)
    dk, dv = torch.zeros(q.shape, **f32), torch.zeros(q.shape, **f32)
    for kv0 in range(0, s_len, key_tile):
        kt, vt = (x[:, :, kv0:kv0 + key_tile].float() for x in (k, v))
        dk_blk, dv_blk = torch.zeros(kt.shape, **f32), torch.zeros(kt.shape, **f32)
        for q0 in range(0, s_len, query_tile):
            rows = slice(q0, q0 + query_tile)
            qt, dot = q[:, :, rows].float(), do[:, :, rows].float()
            x = torch.matmul(kt, qt.transpose(-1, -2)) * mul
            if not online:
                x = x.clamp(-clamp * LOG2E, clamp * LOG2E)
            p_t = torch.exp2(x - lse2[:, :, None, rows])
            ds_t = p_t * (torch.matmul(vt, dot.transpose(-1, -2)) - delta[:, :, None, rows])
            p_t, ds_t = p_t.to(q.dtype).float(), ds_t.to(q.dtype).float()
            dv_blk += torch.matmul(p_t, dot)
            dk_blk += torch.matmul(ds_t, qt)
            dq_acc[:, :, rows] += torch.matmul(ds_t.transpose(-1, -2), kt)
        dk[:, :, kv0:kv0 + key_tile] = dk_blk
        dv[:, :, kv0:kv0 + key_tile] = dv_blk
    return (dq_acc * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)
