"""repro_torch.sched — hierarchical campaign scheduling above the pilot layer.

Public surface:

* :class:`CampaignScheduler` — ordering + admission + gang placement across
  pilots (see ``scheduler.py`` module docs for the architecture).
* Policies: :class:`FIFOPolicy` (seed-equivalent), :class:`PriorityPolicy`
  (classes + aging), :class:`FairSharePolicy` (weighted tenants);
  :func:`make_policy` resolves names.
"""
from repro_torch.sched.policy import (FairSharePolicy, FIFOPolicy,
                                      PriorityPolicy, QueuePolicy, make_policy)
from repro_torch.sched.scheduler import CampaignScheduler

__all__ = ["CampaignScheduler", "QueuePolicy", "FIFOPolicy",
           "PriorityPolicy", "FairSharePolicy", "make_policy"]
