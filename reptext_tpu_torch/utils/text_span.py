"""Token-span location of render text inside an encoded prompt.

The port's copy of ``reptext_tpu/utils/text_span.py`` (numpy only): the
counterpart of the reference's ``get_text_to_render``, which finds the quoted
render text's token span in the T5 prompt ids, for training-time
text-perceptual losses and attention analysis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def find_token_span(prompt_ids: Sequence[int], text_ids: Sequence[int]
                    ) -> Optional[Tuple[int, int]]:
    """First occurrence of ``text_ids`` as a contiguous subsequence.

    Returns (start, end) with end exclusive, or None if absent. Trailing
    pad/eos in ``text_ids`` should be stripped by the caller (tokenizers
    append them).
    """
    p = list(prompt_ids)
    t = list(text_ids)
    if not t or len(t) > len(p):
        return None
    for i in range(len(p) - len(t) + 1):
        if p[i:i + len(t)] == t:
            return (i, i + len(t))
    return None


def render_text_spans(prompt_ids: Sequence[int], per_line_text_ids: Sequence[Sequence[int]],
                      strip_ids: Sequence[int] = (0, 1)) -> List[Optional[Tuple[int, int]]]:
    """Span per rendered text line (quoted into the prompt by the reference's infer.py);
    ``strip_ids`` removes pad/eos from the per-line encodings before matching."""
    spans = []
    for ids in per_line_text_ids:
        core = [i for i in ids if i not in strip_ids]
        spans.append(find_token_span(list(prompt_ids), core))
    return spans


def span_mask(seq_len: int, span: Optional[Tuple[int, int]]) -> np.ndarray:
    """Binary [seq_len] mask over a token span (zeros when span is None)."""
    m = np.zeros((seq_len,), np.float32)
    if span is not None:
        m[span[0]:span[1]] = 1.0
    return m
