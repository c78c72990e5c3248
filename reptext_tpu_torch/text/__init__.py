"""Token-id helpers, copied from ``reptext_tpu/text``.

The tokenizers (CLIP byte-BPE, SentencePiece unigram) wait until tokenizer
files are in the repository; the port's CLI uses demo ids.
"""


def pad_to_common_length(a, b, pad_id: int = 0):
    """Right-pad two [B, S] token-id arrays to a common sequence length.

    True-CFG paths concatenate negative and positive prompt embeddings on the
    batch axis (reference pipeline_flux_controlnet_inpaint.py:1033-1035), so
    their token sequences must match in length; HF tokenizers pad to
    max_length, but the hash-id demo fallback does not.
    """
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    s = max(a.shape[1], b.shape[1])
    out = []
    for x in (a, b):
        if x.shape[1] < s:
            x = np.pad(x, [(0, 0), (0, s - x.shape[1])],
                       constant_values=pad_id)
        out.append(x)
    return out[0], out[1]
