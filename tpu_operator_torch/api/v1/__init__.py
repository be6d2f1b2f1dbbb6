from tpu_operator_torch.api.v1.clusterpolicy_types import (  # noqa: F401
    ClusterPolicy,
    ClusterPolicySpec,
    ClusterPolicyStatus,
    State,
)
