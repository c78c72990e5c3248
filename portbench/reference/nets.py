"""The networks of the pipeline as plain PyTorch functions.

FLUX.1 (double- and single-stream MMDiT blocks, AdaLN-Zero modulation,
per-head RMS q/k norms, 3-axis RoPE, gelu-tanh MLPs, ControlNet residuals
added after each block), the RepText-style ControlNet, the T5 v1.1 encoder,
the CLIP-L text encoder and the FLUX AutoencoderKL, each written from its
published description over a flat ``{name: tensor}`` state dict. Each net
computes in the dtype its weights are stored in (bf16 as served, float32 in
the tests' tiny geometry), the way a bf16 model is run: products in that
dtype with float32 sums, activations and residual streams in it, and every
norm, the RoPE rotation and the attention's logits, softmax and weighted sum
in float32, cast back. Attention is the exact softmax, computed a few heads
at a time so that its float32 logits fit.

Departure from the published parameterisation, shared with the program's
state dicts: RoPE rotates half-split channels (channel j pairs with j + D/2);
a checkpoint in the interleaved order maps onto it by permuting the q and k
projection rows, so the function is the same.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

State = Dict[str, torch.Tensor]
# logits held at once by the attention: heads x S x S float32 elements
ATTENTION_BUDGET = 1 << 29


def w32(sd: State, name: str) -> torch.Tensor:
    return sd[name].float()


def linear(sd: State, name: str, x: torch.Tensor) -> torch.Tensor:
    """x W^T + b in x's dtype."""
    bias = sd.get(f"{name}.bias")
    return F.linear(x, sd[f"{name}.weight"].to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Without affine parameters, in float32 (returned in float32)."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * weight.float()).to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LN(x) (1 + scale) + shift in float32, in x's dtype."""
    return torch.addcmul(shift.float()[:, None], layer_norm(x),
                         1.0 + scale.float()[:, None]).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------------------ attention

def rope_tables(ids: torch.Tensor, axes: Sequence[int], theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-split cos/sin [S, D] from position ids [S, len(axes)]."""
    parts = []
    for a, dim in enumerate(axes):
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=ids.device) / dim)
        parts.append(ids[:, a:a + 1].float() * freqs[None])
    ang = torch.cat(parts, -1)
    return torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The half-split rotation in float32, in x's dtype."""
    h = x.shape[-1] // 2
    xf = x.float()
    return (xf * cos + torch.cat([-xf[..., h:], xf[..., :h]], -1) * sin).to(x.dtype)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention over [B, H, S, D] (``bias`` [1, H, Sq, Sk] added to the
    logits) in float32, returned in q's dtype; in blocks of heads and queries
    whose logits fit the budget. The scale goes on q, so the logits are
    written once and read once by the softmax, whose output the second
    product reads."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    rows = max(1, ATTENTION_BUDGET // sk)            # query rows x heads per block
    hb = max(1, min(h, rows // sq))
    qb = min(sq, max(1, rows // hb))
    dtype = q.dtype
    q, k, v = q.float() * scale, k.float(), v.float()
    out = torch.empty_like(q)
    for i in range(b):
        for j in range(0, h, hb):
            for r in range(0, sq, qb):
                logits = torch.matmul(q[i, j:j + hb, r:r + qb], k[i, j:j + hb].transpose(-1, -2))
                if bias is not None:
                    logits += bias[0, j:j + hb, r:r + qb]
                out[i, j:j + hb, r:r + qb] = torch.matmul(torch.softmax(logits, -1),
                                                          v[i, j:j + hb])
    return out.to(dtype)


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, f = x.shape
    return x.reshape(b, s, n, f // n).transpose(1, 2)


def merge(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def joint_attention(q, k, v, cos, sin) -> torch.Tensor:
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    return merge(softmax_attention(q, k, v, q.shape[-1] ** -0.5))


# ----------------------------------------------------------------------- FLUX

def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Cos-first sinusoidal features [B, dim] of [B] values."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([args.cos(), args.sin()], -1)


def mlp_embed(sd: State, p: str, x: torch.Tensor) -> torch.Tensor:
    return linear(sd, f"{p}.linear_2", F.silu(linear(sd, f"{p}.linear_1", x)))


def conditioning(sd: State, cfg: dict, t: torch.Tensor, pooled: torch.Tensor,
                 guidance: Optional[torch.Tensor]) -> torch.Tensor:
    """temb = MLP(sin(1000 t)) + MLP(sin(1000 g)) + MLP(pooled CLIP); 1000 t
    in t's own dtype, as the deployment computes it."""
    d, dtype = cfg["time_embed_dim"], pooled.dtype
    temb = mlp_embed(sd, "time_text_embed.timestep_embedder", sinusoid(t * 1000.0, d).to(dtype))
    if cfg["guidance_embeds"]:
        temb = temb + mlp_embed(sd, "time_text_embed.guidance_embedder",
                                sinusoid(guidance * 1000.0, d).to(dtype))
    return temb + mlp_embed(sd, "time_text_embed.text_embedder", pooled)


def double_block(sd: State, p: str, x, ctx, temb, cos, sin, n_heads: int):
    """One double-stream block over (image x, text ctx)."""
    silu = F.silu(temb)
    m = linear(sd, f"{p}.norm1.linear", silu).chunk(6, -1)
    mc = linear(sd, f"{p}.norm1_context.linear", silu).chunk(6, -1)
    xi, xt = modulate(x, m[0], m[1]), modulate(ctx, mc[0], mc[1])

    def qkv(names, src, norms):
        q, k, v = (heads(linear(sd, f"{p}.{n}", src), n_heads) for n in names)
        return (rms_norm(q, sd[f"{p}.{norms[0]}.weight"]),
                rms_norm(k, sd[f"{p}.{norms[1]}.weight"]), v)

    qi, ki, vi = qkv(("to_q", "to_k", "to_v"), xi, ("norm_q", "norm_k"))
    qt, kt, vt = qkv(("add_q_proj", "add_k_proj", "add_v_proj"), xt,
                     ("norm_added_q", "norm_added_k"))
    attn = joint_attention(torch.cat([qt, qi], 2), torch.cat([kt, ki], 2),
                           torch.cat([vt, vi], 2), cos, sin)
    s_txt = ctx.shape[1]
    x = x + m[2][:, None] * linear(sd, f"{p}.to_out", attn[:, s_txt:])
    ff = linear(sd, f"{p}.ff.out_proj", gelu_tanh(linear(sd, f"{p}.ff.in_proj",
                                                         modulate(x, m[3], m[4]))))
    x = x + m[5][:, None] * ff
    ctx = ctx + mc[2][:, None] * linear(sd, f"{p}.to_add_out", attn[:, :s_txt])
    ffc = linear(sd, f"{p}.ff_context.out_proj", gelu_tanh(linear(
        sd, f"{p}.ff_context.in_proj", modulate(ctx, mc[3], mc[4]))))
    return x, ctx + mc[5][:, None] * ffc


def single_block(sd: State, p: str, joint, temb, cos, sin, n_heads: int):
    """One single-stream block over [text; image]: attention and MLP in parallel."""
    shift, scale, gate = linear(sd, f"{p}.norm.linear", F.silu(temb)).chunk(3, -1)
    h = modulate(joint, shift, scale)
    mlp = gelu_tanh(linear(sd, f"{p}.proj_mlp", h))
    q = rms_norm(heads(linear(sd, f"{p}.to_q", h), n_heads), sd[f"{p}.norm_q.weight"])
    k = rms_norm(heads(linear(sd, f"{p}.to_k", h), n_heads), sd[f"{p}.norm_k.weight"])
    attn = joint_attention(q, k, heads(linear(sd, f"{p}.to_v", h), n_heads), cos, sin)
    return joint + gate[:, None] * linear(sd, f"{p}.proj_out", torch.cat([attn, mlp], -1))


def inject(n_stack: int, n_layers: int) -> List[int]:
    """The residual each base layer reads: stack[min(i // ceil(L / n), n - 1)]."""
    every = math.ceil(n_layers / n_stack)
    return [min(i // every, n_stack - 1) for i in range(n_layers)]


def flux(sd: State, cfg: dict, x, ctx, pooled, t, img_ids, txt_ids, guidance,
         double_res: Sequence[Sequence[torch.Tensor]] = (),
         single_res: Sequence[Sequence[torch.Tensor]] = ()) -> torch.Tensor:
    """FLUX's velocity [B, S_img, 64] in its weights' dtype; ``double_res``/
    ``single_res``: lists of ControlNet residual stacks, each a list of
    [B, S_img, D] per net layer."""
    n, dtype = cfg["num_attention_heads"], sd["x_embedder.weight"].dtype
    x, ctx, pooled = x.to(dtype), ctx.to(dtype), pooled.to(dtype)
    x = linear(sd, "x_embedder", x)
    temb = conditioning(sd, cfg, t, pooled, guidance)
    ctx = linear(sd, "context_embedder", ctx)
    cos, sin = rope_tables(torch.cat([txt_ids, img_ids]), cfg["axes_dims_rope"],
                           cfg["rope_theta"])
    layers = cfg["num_layers"]
    idx = [inject(len(r), layers) for r in double_res]
    for i in range(layers):
        x, ctx = double_block(sd, f"double_blocks.{i}.block", x, ctx, temb, cos, sin, n)
        for res, ix in zip(double_res, idx):
            x = x + res[ix[i]]
    s_txt = ctx.shape[1]
    joint = torch.cat([ctx, x], 1)
    layers = cfg["num_single_layers"]
    idx = [inject(len(r), layers) for r in single_res]
    for i in range(layers):
        joint = single_block(sd, f"single_blocks.{i}.block", joint, temb, cos, sin, n)
        for res, ix in zip(single_res, idx):
            joint[:, s_txt:] += res[ix[i]]
    scale, shift = linear(sd, "norm_out.linear", F.silu(temb)).chunk(2, -1)
    return linear(sd, "proj_out", modulate(joint[:, s_txt:], shift, scale))


def controlnet(sd: State, cfg: dict, x, cond, ctx, pooled, t, img_ids, txt_ids, guidance,
               scale: float) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """A FLUX ControlNet: the latents plus the embedded condition through its
    blocks; each block's image stream through its ``proj`` head, times
    ``scale``: (double residuals, single residuals), lists of [B, S_img, D],
    in its weights' dtype."""
    n, dtype = cfg["num_attention_heads"], sd["x_embedder.weight"].dtype
    x, cond, ctx, pooled = x.to(dtype), cond.to(dtype), ctx.to(dtype), pooled.to(dtype)
    x = linear(sd, "x_embedder", x) + linear(sd, "controlnet_x_embedder", cond)
    temb = conditioning(sd, cfg, t, pooled, guidance)
    ctx = linear(sd, "context_embedder", ctx)
    cos, sin = rope_tables(torch.cat([txt_ids, img_ids]), cfg["axes_dims_rope"],
                           cfg["rope_theta"])
    doubles, singles = [], []
    for i in range(cfg["num_layers"]):
        x, ctx = double_block(sd, f"double_blocks.{i}.block", x, ctx, temb, cos, sin, n)
        doubles.append(linear(sd, f"double_blocks.{i}.proj", x) * scale)
    s_txt = ctx.shape[1]
    joint = torch.cat([ctx, x], 1)
    for i in range(cfg["num_single_layers"]):
        joint = single_block(sd, f"single_blocks.{i}.block", joint, temb, cos, sin, n)
        singles.append(linear(sd, f"single_blocks.{i}.proj", joint[:, s_txt:]) * scale)
    return doubles, singles


# -------------------------------------------------------------------- encoders

def t5_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bidirectional T5 relative-position buckets of (key - query) offsets."""
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    n = rel.abs()
    exact = num_buckets // 2
    large = exact + (torch.log(n.float() / exact + 1e-6) / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    return out + torch.where(n < exact, n, large.clamp(max=num_buckets - 1))


def t5_norm(sd: State, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return rms_norm(x, sd[name], eps)


def t5(sd: State, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """T5 v1.1 encoder: last hidden states [B, S, d_model]."""
    eps, n = cfg["layer_norm_epsilon"], cfg["num_heads"]
    x = sd["shared.weight"][ids]
    pos = torch.arange(ids.shape[1], device=ids.device)
    buckets = t5_bucket(pos[None] - pos[:, None], cfg["relative_attention_num_buckets"],
                        cfg["relative_attention_max_distance"])
    bias = w32(sd, "relative_attention_bias.weight")[buckets].permute(2, 0, 1)[None]
    for i in range(cfg["num_layers"]):
        p = f"layer_{i}"
        h = t5_norm(sd, f"{p}.attn_layer_norm.weight", x, eps)
        q, k, v = (heads(linear(sd, f"{p}.{m}", h), n) for m in ("q", "k", "v"))
        x = x + linear(sd, f"{p}.o", merge(softmax_attention(q, k, v, 1.0, bias)))
        h = t5_norm(sd, f"{p}.ff_layer_norm.weight", x, eps)
        x = x + linear(sd, f"{p}.wo", gelu_tanh(linear(sd, f"{p}.wi_0", h))
                       * linear(sd, f"{p}.wi_1", h))
    return t5_norm(sd, "final_layer_norm.weight", x, eps)


def clip_pooled(sd: State, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """CLIP-L text encoder: the final-normed hidden state at the EOS (largest) id [B, D]."""
    b, s = ids.shape
    n, eps = cfg["num_heads"], cfg["layer_norm_eps"]

    def ln(name, x):
        return F.layer_norm(x.float(), x.shape[-1:], w32(sd, f"{name}.weight"),
                            w32(sd, f"{name}.bias"), eps).to(x.dtype)

    x = sd["token_embedding.weight"][ids] + sd["position_embedding.weight"][:s][None]
    mask = torch.full((s, s), float("-inf"), device=ids.device).triu(1)[None, None]
    for i in range(cfg["num_layers"]):
        p = f"layer_{i}"
        h = ln(f"{p}.layer_norm1", x)
        q, k, v = (heads(linear(sd, f"{p}.{m}_proj", h), n) for m in ("q", "k", "v"))
        x = x + linear(sd, f"{p}.out_proj",
                       merge(softmax_attention(q, k, v, q.shape[-1] ** -0.5, mask)))
        h = linear(sd, f"{p}.fc1", ln(f"{p}.layer_norm2", x))
        x = x + linear(sd, f"{p}.fc2", h * torch.sigmoid(1.702 * h))
    x = ln("final_layer_norm", x)
    return x[torch.arange(b, device=x.device), ids.argmax(-1)]


# ------------------------------------------------------------------------ VAE

def conv(sd: State, name: str, x: torch.Tensor, stride: int = 1, padding: int = 1):
    return F.conv2d(x, sd[f"{name}.weight"].to(x.dtype), sd[f"{name}.bias"].to(x.dtype),
                    stride, padding)


def group_norm(sd: State, name: str, x: torch.Tensor, groups: int) -> torch.Tensor:
    return F.group_norm(x.float(), groups, w32(sd, f"{name}.norm.weight"),
                        w32(sd, f"{name}.norm.bias"), 1e-6).to(x.dtype)


def resnet(sd: State, p: str, x: torch.Tensor, g: int) -> torch.Tensor:
    h = conv(sd, f"{p}.conv1", F.silu(group_norm(sd, f"{p}.norm1", x, g)))
    h = conv(sd, f"{p}.conv2", F.silu(group_norm(sd, f"{p}.norm2", h, g)))
    if f"{p}.conv_shortcut.weight" in sd:
        x = conv(sd, f"{p}.conv_shortcut", x, padding=0)
    return x + h


def vae_attention(sd: State, p: str, x: torch.Tensor, g: int) -> torch.Tensor:
    b, c, h, w = x.shape
    tok = group_norm(sd, f"{p}.group_norm", x, g).reshape(b, c, h * w).transpose(1, 2)
    q, k, v = (linear(sd, f"{p}.to_{m}", tok)[:, None] for m in ("q", "k", "v"))
    out = linear(sd, f"{p}.to_out", softmax_attention(q, k, v, c ** -0.5)[:, 0])
    return x + out.transpose(1, 2).reshape(b, c, h, w)


def vae_moments(sd: State, cfg: dict, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder: images [B, 3, H, W] in [-1, 1] -> (mean, logvar clamped to
    [-30, 20]), float32."""
    ch, g, n = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
    x = conv(sd, "encoder.conv_in", images.to(sd["encoder.conv_in.weight"].dtype))
    for i in range(len(ch)):
        for j in range(n):
            x = resnet(sd, f"encoder.down_{i}_block_{j}", x, g)
        if i < len(ch) - 1:
            x = conv(sd, f"encoder.down_{i}_downsample", F.pad(x, (0, 1, 0, 1)), 2, 0)
    x = resnet(sd, "encoder.mid_block_1", x, g)
    x = resnet(sd, "encoder.mid_block_2", vae_attention(sd, "encoder.mid_attn", x, g), g)
    x = conv(sd, "encoder.conv_out", F.silu(group_norm(sd, "encoder.norm_out", x, g)))
    mean, logvar = x.float().chunk(2, 1)
    return mean, logvar.clamp(-30.0, 20.0)


def vae_decode(sd: State, cfg: dict, z: torch.Tensor) -> torch.Tensor:
    """Decoder: unscaled latents [B, C, h, w] -> images [B, 3, 8h, 8w]."""
    ch, g, n = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
    x = conv(sd, "decoder.conv_in", z.to(sd["decoder.conv_in.weight"].dtype))
    x = resnet(sd, "decoder.mid_block_1", x, g)
    x = resnet(sd, "decoder.mid_block_2", vae_attention(sd, "decoder.mid_attn", x, g), g)
    for i in range(len(ch)):
        for j in range(n + 1):
            x = resnet(sd, f"decoder.up_{i}_block_{j}", x, g)
        if i < len(ch) - 1:
            x = conv(sd, f"decoder.up_{i}_upsample", F.interpolate(x, scale_factor=2.0,
                                                                    mode="nearest"))
    return conv(sd, "decoder.conv_out", F.silu(group_norm(sd, "decoder.norm_out", x, g)))
