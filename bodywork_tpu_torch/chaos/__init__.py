"""Chaos harness of the port: the seeded fault plan
(:mod:`bodywork_tpu_torch.chaos.plan`), the process-kill points that prove
the run journal's crash resume (:mod:`~bodywork_tpu_torch.chaos.kill`) and
the canary release-safety acceptance
(:mod:`~bodywork_tpu_torch.chaos.canary`). The faulted store, the flaky
HTTP middleware, bit rot and the soak (``bodywork_tpu.chaos.store/http/
bitrot/sim``) are a later slice (ROADMAP)."""
from bodywork_tpu_torch.chaos.canary import CANARY_SCENARIOS, run_canary_chaos
from bodywork_tpu_torch.chaos.kill import (
    EXIT_KILLED,
    KillSwitch,
    SimulatedCrash,
    arm_from_env,
    hit_kill_point,
)
from bodywork_tpu_torch.chaos.plan import FaultPlan, InjectedFault, activate, get_active_plan

__all__ = ["CANARY_SCENARIOS", "EXIT_KILLED", "FaultPlan", "InjectedFault", "KillSwitch",
           "SimulatedCrash", "activate", "arm_from_env", "get_active_plan", "hit_kill_point",
           "run_canary_chaos"]
