"""Runtime: fault detection on live matmul outputs (the OnlineVerifier),
elastic re-meshing and spare pools, and straggler mitigation.  The last two
are host numpy, copies of the reference's."""
from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticPlan,
    SparePool,
    initial_spares,
    plan_remesh,
    spare_pool_ffp,
)
from repro_torch.runtime.online_verify import OnlineVerifier, append_fault  # noqa: F401
from repro_torch.runtime.straggler import StragglerMitigator  # noqa: F401
