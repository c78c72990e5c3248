"""The model FLOPs of one sampler step, from the configuration's shapes.

Every matrix product of FLUX and of each ControlNet that runs in the step, at
2 FLOP per multiply-add: the block projections and MLPs per token, the
modulation and embedding products per row, the embedders and heads per
token, and the two attention products per block (4 B H S^2 D). Norms,
activations and the Euler update are not products and are not counted."""

from __future__ import annotations


def block_macs_per_token(d: int, mlp_ratio: float) -> int:
    """A double block's stream or a single block: q, k, v and the output
    projection (4 d^2) and the MLP (2 d * r d): (4 + 2 r) d^2 either way."""
    return int((4 + 2 * mlp_ratio) * d * d)


def model_flop(cfg: dict, rows: int, s_img: int, s_txt: int, control: bool = False) -> float:
    """One forward of a FLUX-shaped model (``cfg`` the group of the
    configuration file) over ``rows`` rows of ``s_img`` image and ``s_txt``
    text tokens; ``control`` adds a ControlNet's condition embedder and its
    per-block heads."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    r = cfg["mlp_ratio"]
    s = s_img + s_txt
    blocks = cfg["num_layers"] + cfg["num_single_layers"]
    macs = blocks * block_macs_per_token(d, r) * s * rows
    # modulation: 6 d per double-block stream (x2 streams), 3 d per single block
    macs += rows * d * d * (12 * cfg["num_layers"] + 3 * cfg["num_single_layers"])
    # timestep, guidance and pooled-text embedders, then the output norm (FLUX only)
    te = cfg["time_embed_dim"]
    macs += rows * (te * d + d * d) * (2 if cfg["guidance_embeds"] else 1)
    macs += rows * (cfg["pooled_projection_dim"] * d + d * d)
    macs += rows * s_img * cfg["in_channels"] * d + rows * s_txt * cfg["joint_attention_dim"] * d
    if control:
        extra = cfg["in_channels"] + cfg["extra_condition_channels"]
        macs += rows * s_img * (extra * d + blocks * d * d)
    else:
        macs += rows * (d * 2 * d) + rows * s_img * d * cfg["in_channels"]
    attn = 4 * rows * cfg["num_attention_heads"] * s * s * cfg["attention_head_dim"] * blocks
    return 2.0 * macs + attn


def step_flop(config: dict, rows: int, s_img: int, s_txt: int, lines: int = 1) -> float:
    """A sampler step with the ControlNet on: FLUX at ``rows`` rows, the
    RepText ControlNet at ``lines * rows``."""
    return (model_flop(config["flux"], rows, s_img, s_txt)
            + model_flop(config["controlnet"], lines * rows, s_img, s_txt, control=True))
