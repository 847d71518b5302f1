from repro_torch.data.pipeline import PipelineState, SyntheticLMData, input_specs

__all__ = ["PipelineState", "SyntheticLMData", "input_specs"]
