"""Continuous-batching diffusion serving for the port."""
from repro_torch.serving.diffusion_engine import DiffusionServingEngine  # noqa: F401
from repro_torch.serving.scheduler import (SCHED_POLICIES,  # noqa: F401
                                           DiffusionRequest, RequestQueue,
                                           SamplingPlan, piecewise_rate,
                                           poisson_trace, summarize_by_class,
                                           summarize_by_steps)
from repro_torch.serving.slo import (AdmissionController,  # noqa: F401
                                     CompletionPredictor,
                                     DegradationController, ReplicaRouter,
                                     ShedLevel, SLOScheduler)
