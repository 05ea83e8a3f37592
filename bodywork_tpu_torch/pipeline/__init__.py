from bodywork_tpu_torch.pipeline.ab import (
    PipelineVariant,
    VariantResult,
    compare_report,
    format_compare_report,
    run_ab_simulation,
    variants_from_model_types,
)
from bodywork_tpu_torch.pipeline.k8s import generate_manifests, write_manifests
from bodywork_tpu_torch.pipeline.k8s_validate import (
    ManifestError,
    validate_manifest,
    validate_manifests,
)
from bodywork_tpu_torch.pipeline.runner import DayResult, LocalRunner, StageFailure
from bodywork_tpu_torch.pipeline.spec import (
    PipelineSpec,
    ResourceSpec,
    StageSpec,
    default_pipeline,
    parse_dag,
)
from bodywork_tpu_torch.pipeline.stages import StageContext

__all__ = [
    "DayResult",
    "LocalRunner",
    "ManifestError",
    "PipelineSpec",
    "PipelineVariant",
    "ResourceSpec",
    "StageContext",
    "StageFailure",
    "StageSpec",
    "VariantResult",
    "compare_report",
    "default_pipeline",
    "format_compare_report",
    "generate_manifests",
    "parse_dag",
    "run_ab_simulation",
    "validate_manifest",
    "validate_manifests",
    "variants_from_model_types",
    "write_manifests",
]
