"""The port's pipelines."""

from reptext_tpu_torch.pipelines.inpaint import (  # noqa: F401
    DEFAULT_NEGATIVE_PROMPT,
    FluxRepTextInpaintPipeline,
)
from reptext_tpu_torch.pipelines.outputs import FluxPipelineOutput, to_pil_images  # noqa: F401
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline  # noqa: F401
