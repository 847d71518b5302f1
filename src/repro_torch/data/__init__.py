from repro_torch.data.pipeline import PipelineState, SyntheticLMData

__all__ = ["PipelineState", "SyntheticLMData"]
