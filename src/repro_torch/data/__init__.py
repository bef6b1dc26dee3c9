"""Token pipelines for LM training (the reference's ``repro.data``)."""
from repro_torch.data.pipeline import TokenPipeline  # noqa: F401
