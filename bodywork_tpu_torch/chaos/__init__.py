"""Chaos harness of the port (``bodywork_tpu.chaos``): the seeded fault
plan (:mod:`bodywork_tpu_torch.chaos.plan`), the fault-injecting store
(:mod:`~bodywork_tpu_torch.chaos.store`), the flaky scoring service
(:mod:`~bodywork_tpu_torch.chaos.http`), the chaos, bit-rot and crash
soaks (:mod:`~bodywork_tpu_torch.chaos.sim`,
:mod:`~bodywork_tpu_torch.chaos.bitrot`), the process-kill points
(:mod:`~bodywork_tpu_torch.chaos.kill`) and the canary release-safety
acceptance (:mod:`~bodywork_tpu_torch.chaos.canary`)."""
from bodywork_tpu_torch.chaos.bitrot import inject_bit_rot, run_bit_rot_sim
from bodywork_tpu_torch.chaos.canary import (
    CANARY_SCENARIOS,
    run_canary_chaos,
    sabotage_checkpoint_nan,
)
from bodywork_tpu_torch.chaos.http import FlakyScoringMiddleware, flaky_serve_stage
from bodywork_tpu_torch.chaos.kill import (
    EXIT_KILLED,
    KillSwitch,
    SimulatedCrash,
    arm_from_env,
    hit_kill_point,
)
from bodywork_tpu_torch.chaos.plan import FaultPlan, InjectedFault, activate, get_active_plan
from bodywork_tpu_torch.chaos.sim import (
    chaos_pipeline_spec,
    compare_stores,
    run_chaos_sim,
    run_crash_sim,
    sweep_points,
)
from bodywork_tpu_torch.chaos.store import FaultInjectingStore

__all__ = ["CANARY_SCENARIOS", "EXIT_KILLED", "FaultInjectingStore", "FaultPlan",
           "FlakyScoringMiddleware", "InjectedFault", "KillSwitch", "SimulatedCrash",
           "activate", "arm_from_env", "chaos_pipeline_spec", "compare_stores",
           "flaky_serve_stage", "get_active_plan", "hit_kill_point", "inject_bit_rot",
           "run_bit_rot_sim", "run_canary_chaos", "run_chaos_sim", "run_crash_sim",
           "sabotage_checkpoint_nan", "sweep_points"]
