"""repro_torch.services — persistent service tasks + high-throughput function
execution, the third and fourth task modalities on top of the Engine
substrate (alongside executable and batch-function tasks).

* :class:`Service` — N persistent replicas with the PROVISIONING -> READY ->
  SERVING -> DRAINING -> STOPPED lifecycle, fed by a request stream routed
  with pluggable load balancing (round-robin, least-outstanding). The fault
  model requeues requests of dead replicas to survivors (``max_retries``),
  replaces dead replicas through :class:`RestartPolicy`, and autoscales the
  replica count through :class:`ScalePolicy`.
* The ``funcpool`` executor backend (registered for both engines) — a
  Raptor/Dragon-style master/worker pool executing pickled callables inside
  persistent workers: no per-call process spawn in real mode, a calibrated
  per-worker service-rate model in sim mode.

Entry points: ``TaskManager.start_service(...)`` and
``TaskManager.submit_functions(...)`` in ``repro_torch.runtime.session``.
"""
from repro_torch.services.service import (LeastOutstandingBalancer, Replica,
                                          RestartPolicy, RoundRobinBalancer,
                                          ScalePolicy, Service, SVC_STOP,
                                          make_balancer)

__all__ = ["Service", "Replica", "RoundRobinBalancer",
           "LeastOutstandingBalancer", "RestartPolicy", "ScalePolicy",
           "make_balancer", "SVC_STOP"]
