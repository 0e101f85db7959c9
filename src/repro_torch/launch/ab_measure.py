"""Measure a change against its parent on one CUDA card, in one process
tree, alternating the two so that the card's and the host's drift fall on
both.

    PYTHONPATH=src python -m repro_torch.launch.ab_measure \\
        --parent build/parent --out build/ab

``--parent`` is an unpacked checkout of the parent commit (for instance
``git archive <parent> | tar -x -C build/parent``); the change is the
checkout this module runs from.  Steps, each a subprocess run from its
tree's root with that tree's ``src`` on ``PYTHONPATH``, its standard output
in ``<out>/<step>.txt`` and its errors in ``<out>/<step>.err``:

1. ``chip_smoke.py`` of the parent, then of the change (the kernels line
   of each: both trees' kernel times and serve counts from one call);
2. fused_gate alone (``chip_smoke.py``'s ``phase_fused_gate`` at C = 128
   and 64, twice each, in a process of its own): parent, change, change,
   parent;
3. ``launch/profile_serve.py`` on the DiT fastcache serve: parent, metrics
   plane on, plane off, audit at 1.0, fitted maps, fitted maps, plane off,
   plane on, parent;
4. ``launch/profile_llm.py --fastcache``: parent, change, change, parent.

``--only`` keeps the steps whose names start with one of its prefixes, in
this order (``--only gate,smoke_parent``).  Every step runs whatever the steps before it gave.  The last line printed
is one JSON object: each step's exit code and seconds, and ``failed``, the
steps that exited non-zero; the module exits 1 if any did.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CHANGE = Path(__file__).resolve().parents[3]
# run from a tree's root: that tree's chip_smoke.py times its fused_gate
GATE_TIMES = """\
import torch
import chip_smoke
from repro_torch.core import statcache
from repro_torch.cuda_kernels import build, ref
from repro_torch.cuda_kernels.fused_gate import fused_gate
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
chip_smoke.emit({"phase": "device", "nvidia_smi": chip_smoke.smi()})
for c in (128, 64, 128, 64):
    chip_smoke.phase_fused_gate(torch, torch.device("cuda"), fused_gate, ref,
                                statcache, c, build)
"""


def steps(parent: Path, out: Path):
    """(name, tree, argv) of every step, in order."""
    def prof(tag, tree, *flags):
        return (f"profile_serve_{tag}", tree,
                ["-m", "repro_torch.launch.profile_serve",
                 "--out", str(out / f"profile_serve_{tag}.json"), *flags])

    def prof_llm(tag, tree):
        return (f"profile_llm_{tag}", tree,
                ["-m", "repro_torch.launch.profile_llm", "--fastcache",
                 "--out", str(out / f"profile_llm_{tag}.json")])

    def gate(tag, tree):
        return (f"gate_{tag}", tree, ["-c", GATE_TIMES])

    return [("smoke_parent", parent, ["chip_smoke.py"]),
            ("smoke_change", CHANGE, ["chip_smoke.py"]),
            gate("parent1", parent),
            gate("change1", CHANGE),
            gate("change2", CHANGE),
            gate("parent2", parent),
            prof("parent1", parent),
            prof("on1", CHANGE),
            prof("off1", CHANGE, "--no-metrics"),
            prof("audit1", CHANGE, "--audit-fraction", "1.0"),
            prof("fit1", CHANGE, "--fit-maps"),
            prof("fit2", CHANGE, "--fit-maps"),
            prof("off2", CHANGE, "--no-metrics"),
            prof("on2", CHANGE),
            prof("parent2", parent),
            prof_llm("parent1", parent),
            prof_llm("change1", CHANGE),
            prof_llm("change2", CHANGE),
            prof_llm("parent2", parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="unpacked checkout of the parent commit")
    ap.add_argument("--out", default="build/ab")
    ap.add_argument("--only", default="",
                    help="comma-separated prefixes of the steps to run")
    args = ap.parse_args(argv)
    only = tuple(p for p in args.only.split(",") if p)
    parent = Path(args.parent).resolve()
    if not (parent / "chip_smoke.py").is_file():
        raise SystemExit(f"{parent} holds no chip_smoke.py")
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    report = {}
    for name, tree, cmd in steps(parent, out):
        if only and not name.startswith(only):
            continue
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        t0 = time.perf_counter()
        with open(out / f"{name}.txt", "w") as so, \
                open(out / f"{name}.err", "w") as se:
            rc = subprocess.run([sys.executable, *cmd], cwd=tree, env=env,
                                stdout=so, stderr=se).returncode
        report[name] = {"rc": rc, "seconds": time.perf_counter() - t0}
        print(json.dumps({"step": name, **report[name]}), flush=True)
    failed = [k for k, v in report.items() if v["rc"] != 0]
    print(json.dumps({"steps": report, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
