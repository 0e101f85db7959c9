"""The port's diffusion launcher's workload and mesh flags against the
reference launcher (``repro.launch.serve_diffusion``): ``--steps-mix``,
``--guidance-mix``, ``--lockstep``, ``--mesh`` and ``--sync-admission``.

Both launchers serve the reduced dit-b2 (4 requests, 2 slots, 6 steps,
Poisson rate 0.5, seed 0) on the CPU and print a JSON summary; the
schedule (engine and model steps, latencies, the per-budget breakdown),
the mode, the mixes, the async flag and the topology must agree (the
port's topology adds its process-group backend).

The reference's own ``--mesh`` path fails on this JAX (its sharded
engine's serve step raises ``ShardingTypeError``, as its
``tests/test_slo.py::test_preempt_resume_parity_sharded`` does), so the
port's ``--mesh 1,1`` and ``--mesh 2,1`` (two ``gloo`` ranks the launcher
starts) are held to the reference's single-device summary for the
schedule, and to the reference launcher's own rules for the rest: the
topology is the mesh's, ``async_admission`` is ``bool(mesh) and not
sync_admission``.  Each rejection exits with the reference's message.
The launcher's backend choice by card count (``mesh_backend``, the count
faked) and its rank spawner (``launch.mesh.RankGroup``) are held here too.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import json
import sys

import pytest

from repro.launch import serve_diffusion as jlaunch
from repro_torch.launch import serve_diffusion as launch

BASE = ["--arch", "dit-b2", "--reduced", "--requests", "4", "--slots", "2",
        "--steps", "6", "--seed", "0", "--json"]
MIX = ["--steps-mix", "4,6", "--guidance-mix", "1.0,4.0"]
# name: (port flags, reference flags)
CASES = {
    "mix": (MIX, MIX),
    "lockstep": (["--lockstep"], ["--lockstep"]),
    "mesh_1x1": (["--mesh", "1,1"] + MIX, MIX),
    "mesh_1x1_sync": (["--mesh", "1,1", "--sync-admission"], []),
    "mesh_2x1": (["--mesh", "2,1"] + MIX, MIX),
}
# the reference launcher's summary rules for a mesh: its topology, and
# async admission unless --sync-admission
MESH_TOPOLOGY = {"mesh_1x1": ({"data": 1, "model": 1, "devices": 1}, True),
                 "mesh_1x1_sync": ({"data": 1, "model": 1, "devices": 1},
                                   False),
                 "mesh_2x1": ({"data": 2, "model": 1, "devices": 2}, True)}
SCHEDULE = ("engine_steps", "model_steps", "latency_steps_p50",
            "latency_steps_p95", "latency_by_steps")
REJECTIONS = {
    "nocfg_guidance": ["--no-cfg", "--guidance", "4.0"],
    "nocfg_mix": ["--no-cfg", "--guidance", "1.0", "--guidance-mix",
                  "1.0,4.0"],
    "slo_lockstep": ["--slo", "--lockstep"],
}


def _reference(monkeypatch, capsys, flags):
    monkeypatch.setattr(sys, "argv", ["serve_diffusion", *BASE, *flags])
    capsys.readouterr()
    jlaunch.main()
    return json.loads(capsys.readouterr().out)


def _port(capsys, flags):
    capsys.readouterr()
    launch.main([*BASE, "--device", "cpu", *flags])
    return json.loads(capsys.readouterr().out)


@pytest.fixture(scope="module")
def runs():
    """Each case's (port summary, reference summary), filled on first
    use."""
    return {}


def _case(runs, monkeypatch, capsys, name):
    if name not in runs:
        mine, ref = CASES[name]
        runs[name] = (_port(capsys, mine),
                      _reference(monkeypatch, capsys, ref))
    return runs[name]


@pytest.mark.parametrize("name", list(CASES))
def test_summary_matches_reference(runs, monkeypatch, capsys, name):
    got, want = _case(runs, monkeypatch, capsys, name)
    for k in SCHEDULE + ("mode", "steps_mix", "guidance_mix"):
        assert got[k] == want[k], (name, k)
    assert got["finished"] == want["requests"]
    topo = dict(got["topology"])
    if name in MESH_TOPOLOGY:
        assert topo.pop("backend") == "gloo"
        assert (topo, got["async_admission"]) == MESH_TOPOLOGY[name]
        assert want["topology"] == {"data": 1, "model": 1, "devices": 1}
    else:
        assert topo == want["topology"], name
        assert got["async_admission"] == want["async_admission"], name


def test_mixes_and_modes(runs, monkeypatch, capsys):
    mix = _case(runs, monkeypatch, capsys, "mix")[0]
    assert mix["steps_mix"] == [4, 6] and mix["guidance_mix"] == [1.0, 4.0]
    assert mix["mode"] == "continuous" and not mix["async_admission"]
    lock = _case(runs, monkeypatch, capsys, "lockstep")[0]
    assert lock["mode"] == "lockstep" and lock["steps_mix"] == [6]
    sync = _case(runs, monkeypatch, capsys, "mesh_1x1_sync")[0]
    assert sync["async_admission"] is False
    assert _case(runs, monkeypatch, capsys, "mesh_1x1")[0][
        "async_admission"] is True


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_rejections_match_reference(monkeypatch, capsys, name):
    flags = REJECTIONS[name]
    with pytest.raises(SystemExit) as mine:
        launch.main([*BASE, "--device", "cpu", *flags])
    monkeypatch.setattr(sys, "argv", ["serve_diffusion", *BASE, *flags])
    with pytest.raises(SystemExit) as ref:
        jlaunch.main()
    assert mine.value.code == ref.value.code
    assert isinstance(mine.value.code, str) and mine.value.code


def test_bad_mesh_flag_exits():
    with pytest.raises(SystemExit, match="data,model"):
        launch.parse_args(["--mesh", "2"])


def test_mesh_backend_follows_the_card_count(monkeypatch):
    """nccl with a card per rank, gloo when ranks share the cards there
    are (rank r on card r mod n) and on the CPU."""
    monkeypatch.setattr(launch.torch.cuda, "device_count", lambda: 1)
    assert launch.mesh_backend("cuda", 1) == ("nccl", ["cuda:0"])
    assert launch.mesh_backend("cuda", 2) == ("gloo", ["cuda:0", "cuda:0"])
    monkeypatch.setattr(launch.torch.cuda, "device_count", lambda: 2)
    assert launch.mesh_backend("cuda", 2) == ("nccl", ["cuda:0", "cuda:1"])
    assert launch.mesh_backend("cuda", 4) == \
        ("gloo", ["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    assert launch.mesh_backend("cpu", 2) == ("gloo", ["cpu", "cpu"])


def test_rank_group_returns_each_ranks_result_or_raises():
    """``launch.mesh.run_ranks``: each rank's result by rank; a rank's
    error comes back with its traceback; a rank that does not answer in
    time is killed and the call raises."""
    from repro_torch.launch.mesh import RankGroup, run_ranks
    from tests.torch_sharded_ranks import echo_rank
    assert run_ranks(echo_rank, 2, timeout=120) == [(0, 2), (1, 2)]
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        run_ranks(echo_rank, 2, (1,), timeout=120)
    assert "rank 1 fails on purpose" in str(err.value)
    group = RankGroup(echo_rank, 2, (None, 600.0), timeout=5)
    with pytest.raises(RuntimeError, match="no result within"):
        group.results()
    assert all(not p.is_alive() for p in group.procs)
