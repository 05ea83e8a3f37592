from bodywork_tpu_torch.pipeline.runner import DayResult, LocalRunner, StageFailure
from bodywork_tpu_torch.pipeline.spec import PipelineSpec, StageSpec, default_pipeline, parse_dag
from bodywork_tpu_torch.pipeline.stages import StageContext

__all__ = [
    "DayResult",
    "LocalRunner",
    "PipelineSpec",
    "StageContext",
    "StageFailure",
    "StageSpec",
    "default_pipeline",
    "parse_dag",
]
