"""The training products' share of their roofline: the least time the
card could take for a step's products (each at the f32-accurate peak or
the memory rate, ``yardstick.train_gemm_bound_s``) over the device time
of the GEMM kernels (cuBLAS's ``gemm``/``gemv`` kernels and their
split-K reductions) a step in the trace of one whole fit."""
from portbench.harness import tracesum


def is_gemm(name: str) -> bool:
    low = name.lower()
    return "gemm" in low or "gemv" in low or "splitk" in low


def read(layer):
    trace = layer.get("trace") if layer.get("kind") == "train" else None
    if not trace:
        return None
    seconds = sum(s for name, (s, _n) in tracesum.seconds_by_name(trace).items()
                  if is_gemm(name))
    if seconds <= 0:
        return None
    return 100.0 * layer["gemm_bound_s_per_step"] * trace["steps"] / seconds
