"""Chaos harness of the port: so far the seeded process-kill points
(:mod:`bodywork_tpu_torch.chaos.kill`) that prove the run journal's
crash resume. The fault plan, the faulted store and the soak
(``bodywork_tpu.chaos.plan/store/sim``) are a later slice (ROADMAP)."""
from bodywork_tpu_torch.chaos.kill import (
    EXIT_KILLED,
    KillSwitch,
    SimulatedCrash,
    arm_from_env,
    hit_kill_point,
)

__all__ = ["EXIT_KILLED", "KillSwitch", "SimulatedCrash", "arm_from_env", "hit_kill_point"]
