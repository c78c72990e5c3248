"""CPU glyph-conditioning frontend: Arabic shaping, glyph render, masks, canny.

The port's own copy of ``reptext_tpu/conditioning`` (numpy, scipy and PIL
only), so that the port never imports the JAX package; ``tests/test_torch_host.py``
holds it bit for bit against the original.
"""

from reptext_tpu_torch.conditioning.arabic import (  # noqa: F401
    bidi_reorder,
    contains_arabic,
    prepare_display_text,
    shape_arabic,
)
from reptext_tpu_torch.conditioning.canny import canny_edges, inverted_canny_rgb  # noqa: F401
from reptext_tpu_torch.conditioning.glyph import (  # noqa: F401
    Conditions,
    LineCondition,
    TextLine,
    build_conditions,
    build_line_condition,
    default_font_path,
    render_glyph_line,
)
