"""The port's pipelines."""

from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline  # noqa: F401
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline  # noqa: F401
