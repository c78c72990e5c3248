"""The port's pipelines."""

from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline  # noqa: F401
