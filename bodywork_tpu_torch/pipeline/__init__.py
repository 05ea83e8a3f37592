from bodywork_tpu_torch.pipeline.ab import (
    PipelineVariant,
    VariantResult,
    compare_report,
    format_compare_report,
    run_ab_simulation,
    variants_from_model_types,
)
from bodywork_tpu_torch.pipeline.runner import DayResult, LocalRunner, StageFailure
from bodywork_tpu_torch.pipeline.spec import PipelineSpec, StageSpec, default_pipeline, parse_dag
from bodywork_tpu_torch.pipeline.stages import StageContext

__all__ = [
    "DayResult",
    "LocalRunner",
    "PipelineSpec",
    "PipelineVariant",
    "StageContext",
    "StageFailure",
    "StageSpec",
    "VariantResult",
    "compare_report",
    "default_pipeline",
    "format_compare_report",
    "parse_dag",
    "run_ab_simulation",
    "variants_from_model_types",
]
