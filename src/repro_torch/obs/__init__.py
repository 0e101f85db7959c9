"""Observability of the port: device-resident serving metrics, request
tracing, the shadow-compute audit plane and the offline calibration
recorder, after the reference's ``obs`` package.

- **metrics** (``obs.metrics``): a dict of tensors on the engine's device,
  updated in place by each serve step (one batched update) and fetched to
  the host only by ``MetricsCollector.harvest`` at run end or window
  close;
- **tracing** (``obs.tracing``): per-request Chrome/Perfetto trace JSON,
  a diagnostic mode with host clocks per step and deferred device
  snapshots;
- **calibration** (``obs.calibration``): the nocache per-layer delta
  recorder (offline; reads its result once at the end);
- **audit** (``obs.audit``): on a deterministic seeded fraction of serve
  steps the step also runs the full uncached forward and folds
  cached-vs-true error into the metrics and the per-request accumulators.
"""
from repro_torch.obs.audit import (DEFAULT_AUDIT_FRACTION, audit_mask,
                                   audit_report)
from repro_torch.obs.calibration import (load_calibration,
                                         record_calibration,
                                         save_calibration)
from repro_torch.obs.metrics import (METRICS, MetricsCollector, MetricSpec,
                                     counter, histogram, histogram_quantile,
                                     init_device_metrics, parse_prometheus)
from repro_torch.obs.tracing import TraceRecorder, validate_trace

__all__ = [
    "DEFAULT_AUDIT_FRACTION", "METRICS", "MetricSpec", "MetricsCollector",
    "TraceRecorder", "audit_mask", "audit_report", "counter", "histogram",
    "histogram_quantile", "init_device_metrics", "load_calibration",
    "parse_prometheus", "record_calibration", "save_calibration",
    "validate_trace",
]
