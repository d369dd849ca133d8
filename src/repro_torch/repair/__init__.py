"""repro_torch.repair: model-side fault remediation past the DPPU capacity.

HyCA's DPPU recomputes up to ``capacity`` faulty PEs; past that the runtime
retires capacity (column-prefix discard).  This package recovers that regime
in the model instead:

  * :mod:`repro_torch.repair.plan`  — the salience-aware remap planner: a
    static permutation routes the least important output residue classes
    onto the unrepairable PE columns (host and batched device planners);
  * :mod:`repro_torch.repair.remap` — salience estimators (weight norm, and
    the :class:`~repro_torch.repair.remap.SalienceProbe` for activations);
  * :mod:`repro_torch.repair.prune` — the no-permutation fallback: zero the
    channels mapped onto unrepaired PEs in place.

  * :mod:`repro_torch.repair.retrain` — the budgeted fine-tune with the
    faulty array and the plan in the forward pass.

    sal = weight_salience(params, hyca.cols)
    plan = remap_plan(confirmed_state, hyca, sal)
    ftc.swap(plan=plan)          # rewrites the held mask grids in place
"""
from repro_torch.core.engine import RepairPlan, identity_plan  # noqa: F401
from repro_torch.repair.plan import (  # noqa: F401
    plan_summary,
    remap_plan,
    remap_plan_device,
    unrepaired_fault_columns,
)
from repro_torch.repair.prune import (  # noqa: F401
    prune_plan,
    pruned_fraction,
    pruned_pe_fraction,
)
from repro_torch.repair.retrain import RetrainConfig, grad_mask, retrain  # noqa: F401
from repro_torch.repair.remap import (  # noqa: F401
    SalienceProbe,
    fold_channel_salience,
    site_weight_salience,
    weight_salience,
)
