"""What the sharded engine's step graphs rest on, on two gloo ranks of the
CPU (``tests/torch_sharded_ranks.graph_rule_rank``): the graphs
themselves run only on the card (``tests/test_torch_cuda.py -k
sharded_graph``).

- The device agreement a capture makes under a model group
  (``step_graph.agreed_mask``): on the (1, 2) mesh the (1,) AND of both
  ranks' ``all(mask)``, on (2, 1) the rank's own mask, with every host
  read refused.
- The construction rule (``step_graph.capture_refusal``): the CPU
  refuses; a card refuses a gloo model group (model = 2 here) and takes a
  mesh whose model axis is one device.  The engine's default follows it
  (off on the CPU); ``step_graph=True`` where it refuses raises
  ``ValueError``, through ``Workload.build_engine(mesh=...)`` too.
- The numerics self-check (model = 2) leaves the runner's graph setting
  as it found it (set as on the card) and captures nothing.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import pytest

from repro_torch.launch.mesh import run_ranks
from tests.torch_sharded_ranks import AGREED, graph_rule_rank

TOPOS = ((1, 2), (2, 1))


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(graph_rule_rank, 2, timeout=120.0, label="graph rule")


@pytest.mark.parametrize("rank", [0, 1])
def test_model_group_agrees_on_the_device(ranks, rank):
    got = ranks[rank]["agreed"][(1, 2)]
    assert [g[:2] for g in got] == [((1,), "torch.bool")] * len(AGREED)
    assert [g[2] for g in got] == [[a] for a in AGREED]


@pytest.mark.parametrize("rank", [0, 1])
def test_no_model_group_keeps_the_mask(ranks, rank):
    from tests.torch_sharded_ranks import AGREE_MASKS
    got = ranks[rank]["agreed"][(2, 1)]
    assert [g[2] for g in got] == AGREE_MASKS[rank]
    assert all(g[3] for g in got)          # the mask itself, not a copy


@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_capture_rule(ranks, topo):
    for res in ranks:
        why = res["refusal"][topo]
        assert "CUDA graphs" in why["cpu"]
        if topo[1] > 1:
            assert "gloo" in why["cuda"]
        else:
            assert why["cuda"] is None


@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_engine_default_and_refusal_on_the_cpu(ranks, topo):
    for res in ranks:
        assert res["default"][topo] is False
        for how in ("explicit", "build_engine"):
            msg = res[how][topo]
            assert msg is not None and "step_graph=True" in msg, (how, msg)
            assert "CUDA graphs" in msg, (how, msg)


def test_self_check_leaves_the_graph_setting(ranks):
    for res in ranks:
        # the (1, 2) engine's default build ran it (model > 1); the
        # step_graph=True builds raise before it
        assert res["self_check"] == [{"after": True, "captures": 0,
                                      "graphs": 0}], res["self_check"]
