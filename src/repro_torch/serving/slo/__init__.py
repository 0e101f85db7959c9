"""SLO-aware serving control plane over the diffusion engine, after the
reference's ``serving/slo/``.

Host-side only: every decision (admission, preemption, shedding, routing)
is made from host bookkeeping between engine steps, and the only device
work it adds is the engine's preemption pair (``preempt`` and the resuming
``add_request``), which copies rows on the card and reads nothing back.

- ``admission``: ``CompletionPredictor`` (finish-step prediction from the
  slots' step counters + a measured ``model_step_ms`` EMA) and
  ``AdmissionController`` (reject or defer requests whose predicted
  completion misses their deadline);
- ``controller``: ``ShedLevel`` ladders + ``DegradationController``
  (shrink step budgets per priority class under sustained queue pressure);
- ``plane``: ``SLOScheduler``, the per-engine tick (observe -> preempt ->
  admit -> step);
- ``router``: ``ReplicaRouter``, join-shortest-queue + class affinity
  across N engines.
"""
from repro_torch.serving.slo.admission import (AdmissionController,  # noqa: F401
                                               CompletionPredictor,
                                               REASON_EXPIRED,
                                               REASON_UNATTAINABLE)
from repro_torch.serving.slo.controller import (DEFAULT_SHED_LEVELS,  # noqa: F401
                                                DegradationController,
                                                ShedLevel)
from repro_torch.serving.slo.plane import SLOScheduler, StepTimer  # noqa: F401
from repro_torch.serving.slo.router import ReplicaRouter  # noqa: F401
