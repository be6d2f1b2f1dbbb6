"""Fleet-lifecycle chaos: seeded replayable event schedules, a global
invariant checker, and the soak runner that drives them against a
converging KubeSim fleet. The port's copy of ``tpu_operator/chaos``."""

from tpu_operator_torch.chaos.schedule import ChaosEvent, ChaosSchedule  # noqa: F401
from tpu_operator_torch.chaos.soak import InvariantChecker, SoakRunner  # noqa: F401
