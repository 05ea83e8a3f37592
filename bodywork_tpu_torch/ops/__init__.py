from bodywork_tpu_torch.ops.mlp_kernel import (
    KERNEL_ENGINES,
    LAUNCHES,
    ROW_TILE,
    fold_scaler_into_net,
    make_kernel_mlp_apply,
    mlp_stack_plain,
    quantize_int8,
    reset_launches,
)

__all__ = [
    "KERNEL_ENGINES",
    "LAUNCHES",
    "ROW_TILE",
    "fold_scaler_into_net",
    "make_kernel_mlp_apply",
    "mlp_stack_plain",
    "quantize_int8",
    "reset_launches",
]
