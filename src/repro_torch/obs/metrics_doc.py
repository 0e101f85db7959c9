"""Render the port's metrics registry as a Markdown reference table.

    PYTHONPATH=src python -m repro_torch.obs.metrics_doc [PATH]

The registry (``obs.metrics.METRICS``) is the single source of metric
names; this module renders it (name, type, buckets, help) in the
reference's table format.  Without a path argument the document is printed
to stdout; nothing in the repository is written unless a path is given.
"""
from __future__ import annotations

import sys

from repro_torch.obs import metrics as obs_metrics

_HEADER = """\
# Metrics reference (PyTorch port)

Every metric registered by the port's observability plane
(`src/repro_torch/obs/metrics.py`), in registration order.  Device metrics
are tensors on the engine's device, updated in place by each serve step and
fetched to the host only at `MetricsCollector.harvest`; host metrics
(admission/latency clocks) never touch the device.  Exported as Prometheus
text exposition (`--metrics-out`) and JSONL windows (`--metrics-jsonl`).
"""


def _buckets(spec: obs_metrics.MetricSpec) -> str:
    if spec.kind != "histogram":
        return "—"
    return ", ".join(f"{b:g}" for b in spec.buckets) + ", +Inf"


def render() -> str:
    lines = [_HEADER]
    lines.append("| metric | type | buckets (le) | help |")
    lines.append("|---|---|---|---|")
    for spec in obs_metrics.METRICS.values():
        help_text = (spec.help or "").replace("|", "\\|")
        lines.append(f"| `{spec.name}` | {spec.kind} | {_buckets(spec)} "
                     f"| {help_text} |")
    lines.append("")
    lines.append(f"{len(obs_metrics.METRICS)} metrics registered.")
    return "\n".join(lines) + "\n"


def main() -> None:
    doc = render()
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(doc)
        print(f"[metrics-doc] wrote {len(obs_metrics.METRICS)} metrics "
              f"-> {sys.argv[1]}")
    else:
        sys.stdout.write(doc)


if __name__ == "__main__":
    main()
