"""The port's observability plane (``repro_torch.obs``) against the
reference's (``repro.obs``): the registry, the device plane's updates, the
collector's harvest and exports, the Prometheus parser, the metrics doc,
the trace recorder, and the metrics of a served trace.

Tolerances: counters, histogram bins and per-slot step counts exact;
Prometheus text and JSONL windows equal character for character for the
same observations (the windows' wall-clock stamp, a host clock, set to 0 on
both sides first); the served trace's float sums at rtol 1e-4 (f32).
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.obs import metrics as jm
from repro.obs import metrics_doc as jdoc
from repro.obs import tracing as jtracing
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import poisson_trace as jpoisson_trace
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.runner import CachedDiT
from repro_torch.obs import (METRICS, MetricsCollector, TraceRecorder,
                             counter, histogram, init_device_metrics,
                             parse_prometheus, validate_trace)
from repro_torch.obs import metrics as tm
from repro_torch.obs import metrics_doc as tdoc
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import poisson_trace
from tests.test_torch_model import jax_dit, port_dit, t32

TRACE = dict(num_requests=4, rate=0.5, seed=5, steps_mix=(4, 6),
             guidance_mix=(1.0, 4.0))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if k == "flat" and not prefix:
            continue
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_tree(port_host, ref_tree):
    got = dict(_leaves(port_host))
    want = {k: np.asarray(v) for k, v in _leaves(
        jax.tree.map(np.asarray, ref_tree))}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_registry_equals_reference():
    """Same names in the same order, same kind, help and buckets; the same
    device-plane memberships."""
    assert list(tm.METRICS) == list(jm.METRICS)
    for name, spec in jm.METRICS.items():
        mine = tm.METRICS[name]
        assert (mine.name, mine.kind, mine.help, mine.buckets) == \
            (spec.name, spec.kind, spec.help, spec.buckets), name
    for group in ("DEVICE_COUNTERS", "DEVICE_HISTOGRAMS", "DEVICE_PER_SLOT",
                  "AUDIT_COUNTERS", "AUDIT_HISTOGRAMS", "AUDIT_PER_SLOT",
                  "TOKEN_COUNTERS", "TOKEN_PER_SLOT"):
        assert getattr(tm, group) == getattr(jm, group), group


def test_serving_set_names_each_metric_once():
    """The port registers its serving set from one table in one loop, which
    the reference's tree-wide lint of literal registration sites does not
    read; so the table itself must name each metric once, and register
    every one of them."""
    names = [name for _, name, _, _ in tm._SERVING_SET]
    assert len(names) == len(set(names))
    assert set(names) <= set(tm.METRICS)


def test_duplicate_registration_with_different_spec_raises():
    name = counter("_torch_obs_probe_total", "probe")
    try:
        assert counter("_torch_obs_probe_total", "probe") == name
        with pytest.raises(ValueError, match="already registered"):
            counter("_torch_obs_probe_total", "different help")
        with pytest.raises(ValueError, match="already registered"):
            histogram("_torch_obs_probe_total", "now a histogram")
    finally:
        del METRICS[name]
    with pytest.raises(ValueError, match="not a valid"):
        counter("bad-name")
    with pytest.raises(ValueError, match="ascending"):
        histogram("_torch_obs_bad_buckets", buckets=(2, 1))
    assert "_torch_obs_bad_buckets" not in METRICS


# ---------------------------------------------------------------------------
# Device plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planes", ["base", "audit_tokens"])
def test_device_updates_equal_reference(planes):
    """The same observations through both packages' inc / observe /
    observe_many / slot_add: every leaf equal, in the same layout."""
    kw = ({} if planes == "base"
          else dict(audit_layers=5, token_metrics=True))
    rng = np.random.default_rng(3)
    vals = rng.uniform(0.0, 2.0, size=(4,)).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    m = init_device_metrics(4, device="cpu", **kw)
    j = jm.init_device_metrics(4, **kw)
    for name, v in ((tm.SERVE_STEPS, 2.0), (tm.BLOCKS_SKIPPED, 7.0)):
        tm.inc(m, name, v)
        j = jm.inc(j, name, v)
    tm.inc(m, tm.ACTIVE_SLOT_STEPS, torch.tensor(3.0))
    j = jm.inc(j, jm.ACTIVE_SLOT_STEPS, jnp.float32(3.0))
    for v in (0.0, 3.0, 4.0, 1e9):                  # edges and overflow
        tm.observe(m, tm.ACTIVE_SLOTS, v)
        j = jm.observe(j, jm.ACTIVE_SLOTS, v)
    for v in vals[:2]:
        tm.observe(m, tm.SKIP_FRACTION, torch.tensor(float(v)))
        j = jm.observe(j, jm.SKIP_FRACTION, jnp.float32(v))
    tm.slot_add(m, tm.SLOT_ACTIVE_STEPS, torch.from_numpy(w))
    j = jm.slot_add(j, jm.SLOT_ACTIVE_STEPS, jnp.asarray(w))
    if planes != "base":
        err = np.array([1e-5, 2e-3, 0.5, 7.0], np.float32)
        tm.observe_many(m, tm.AUDIT_REL_ERR, torch.from_numpy(err),
                        torch.from_numpy(w))
        j = jm.observe_many(j, jm.AUDIT_REL_ERR, jnp.asarray(err),
                            jnp.asarray(w))
    _same_tree(tm.to_host(m), j)


def test_batched_step_update_equals_single_updates():
    """``DeviceUpdate`` (the engines' one batched update per step) gives
    the leaves the single updates give, host and device values mixed."""
    a = init_device_metrics(3, device="cpu", token_metrics=True)
    b = init_device_metrics(3, device="cpu", token_metrics=True)
    active = np.array([1.0, 0.0, 1.0], np.float32)
    for frac, skipped in ((0.25, 3.0), (0.9, 0.0), (1.0, 5.0)):
        up = tm.DeviceUpdate(a)
        up.inc(tm.SERVE_STEPS, 1.0)
        up.inc(tm.BLOCKS_SKIPPED, torch.tensor(skipped))
        up.observe(tm.ACTIVE_SLOTS, 2.0)
        up.observe(tm.SKIP_FRACTION, torch.tensor(frac))
        up.slot_add(tm.SLOT_ACTIVE_STEPS, active)
        up.slot_add(tm.SLOT_MERGE_RATIO, torch.tensor([0.5, 0.0, 0.25]))
        up.apply()
        tm.inc(b, tm.SERVE_STEPS, 1.0)
        tm.inc(b, tm.BLOCKS_SKIPPED, torch.tensor(skipped))
        tm.observe(b, tm.ACTIVE_SLOTS, 2.0)
        tm.observe(b, tm.SKIP_FRACTION, torch.tensor(frac))
        tm.slot_add(b, tm.SLOT_ACTIVE_STEPS, torch.from_numpy(active))
        tm.slot_add(b, tm.SLOT_MERGE_RATIO, torch.tensor([0.5, 0.0, 0.25]))
    for (pa, va), (pb, vb) in zip(_leaves(tm.to_host(a)),
                                  _leaves(tm.to_host(b))):
        assert pa == pb
        np.testing.assert_array_equal(va, vb, err_msg=str(pa))


def test_histogram_overflow_bin():
    m = init_device_metrics(1, device="cpu")
    tm.observe(m, tm.ACTIVE_SLOTS, 1e9)
    tm.observe(m, tm.ACTIVE_SLOTS, torch.tensor(1e9))
    h = tm.to_host(m)["hist"][tm.ACTIVE_SLOTS]
    assert float(h["bucket"][-1]) == 2.0
    assert float(h["bucket"][:-1].sum()) == 0.0


# ---------------------------------------------------------------------------
# Host plane: collector, harvest, exports
# ---------------------------------------------------------------------------

def test_collector_kind_mismatch_and_window_validation():
    c = MetricsCollector()
    with pytest.raises(ValueError, match="not a counter"):
        c.inc(tm.REQUEST_LATENCY)
    with pytest.raises(ValueError, match="not a histogram"):
        c.observe(tm.ADMISSIONS, 1.0)
    with pytest.raises(ValueError, match="unknown metric"):
        c.inc("never_registered_total")
    with pytest.raises(ValueError, match="window_steps"):
        MetricsCollector(window_steps=0)


def _both_collectors(labels=None):
    """A port and a reference collector fed the same host observations and
    the same device metrics (audit plane on, with a bound, a baseline and a
    fraction installed)."""
    ref = jm.MetricsCollector(labels=labels)
    mine = MetricsCollector(labels=labels)
    base = np.full((2, 5), 0.2, np.float32)
    for c in (ref, mine):
        c.inc(tm.ADMISSIONS, 3)
        for v in (3.0, 9.0, 1000.0, 1e12):
            c.observe(tm.REQUEST_LATENCY, v)
        c.set_gauge("run_wall_seconds", 1.25)
        c.set_audit_context(bound=1.04, baseline=base, fraction=0.5)
    m = init_device_metrics(2, device="cpu", audit_layers=3)
    j = jm.init_device_metrics(2, audit_layers=3)
    err = np.array([0.02, 0.3], np.float32)
    act = np.array([1.0, 1.0], np.float32)
    tm.inc(m, tm.SERVE_STEPS, 5.0)
    j = jm.inc(j, jm.SERVE_STEPS, 5.0)
    tm.inc(m, tm.AUDIT_SLOT_STEPS, 2.0)
    j = jm.inc(j, jm.AUDIT_SLOT_STEPS, 2.0)
    tm.observe_many(m, tm.AUDIT_REL_ERR, torch.from_numpy(err),
                    torch.from_numpy(act))
    j = jm.observe_many(j, jm.AUDIT_REL_ERR, jnp.asarray(err),
                        jnp.asarray(act))
    tm.slot_add(m, tm.SLOT_AUDIT_ERR, torch.from_numpy(err))
    j = jm.slot_add(j, jm.SLOT_AUDIT_ERR, jnp.asarray(err))
    lerr = np.array([0.0, 0.01, 0.05], np.float32)
    m["audit"]["layer_err_sum"].add_(torch.from_numpy(lerr))
    m["audit"]["layer_rows"].add_(2.0)
    j = {**j, "audit": {"layer_err_sum": jnp.asarray(lerr),
                        "layer_rows": jnp.float32(2.0)}}
    return ref, mine, j, m


def _strip_clock(c):
    for w in c.windows:
        w["wall_s"] = 0.0


def test_harvest_merges_both_planes_as_the_reference():
    ref, mine, j, m = _both_collectors({"policy": "fastcache"})
    for step in (7, 8):                 # cumulative, not deltas
        wr = ref.harvest(j, at_step=step)
        wm = mine.harvest(m, at_step=step)
        wr["wall_s"] = wm["wall_s"] = 0.0
        assert json.dumps(wm) == json.dumps(wr)
    assert mine.totals() == ref.totals()
    assert mine.totals()[tm.SERVE_STEPS] == 5.0
    assert mine.windows[-1]["audit"]["drift_ratio"] > 0.0
    for q in (0.5, 0.95):
        assert mine.quantile(tm.AUDIT_REL_ERR, q) == \
            ref.quantile(jm.AUDIT_REL_ERR, q)


def test_prometheus_and_jsonl_equal_reference():
    labels = {"policy": 'a\\b"c\nd', "arch": "dit-b2"}
    ref, mine, j, m = _both_collectors(labels)
    ref.harvest(j, at_step=4)
    mine.harvest(m, at_step=4)
    ref.inc(tm.ADMISSIONS)
    mine.inc(tm.ADMISSIONS)
    ref.harvest(j, at_step=8)
    mine.harvest(m, at_step=8)
    assert mine.to_prometheus() == ref.to_prometheus()
    _strip_clock(ref)
    _strip_clock(mine)
    assert mine.to_jsonl() == ref.to_jsonl()
    assert len(mine.to_jsonl().strip().splitlines()) == 2


def test_parse_prometheus_round_trips_as_the_reference():
    """Escaped label values, +Inf buckets, ±Inf values and NaN gauges
    round-trip, and both parsers read the same text alike."""
    nasty = 'a\\b"c\nd'
    c = MetricsCollector(labels={"policy": nasty, "plain": "ok"})
    c.inc(tm.ADMISSIONS, 1)
    c.observe(tm.REQUEST_LATENCY, 1e12)            # overflow bin
    c.set_gauge("empty_window_ratio", float("nan"))
    text = c.to_prometheus()
    assert 'le="+Inf"' in text and "NaN" in text
    parsed = parse_prometheus(text)
    labels, value = parsed["repro_" + tm.ADMISSIONS]["samples"][0]
    assert labels == {"policy": nasty, "plain": "ok"} and value == 1.0
    lat = parsed["repro_" + tm.REQUEST_LATENCY]
    by_le = {s[0]["le"]: s[1] for s in lat["samples"] if "le" in s[0]}
    assert by_le["+Inf"] == 1.0
    assert all(v == 0.0 for le, v in by_le.items() if le != "+Inf")
    nan = parsed["repro_empty_window_ratio"]["samples"][0][1]
    assert nan != nan
    extra = 'm{a="x\\"y",b="z"} 2\ng 1\nh +Inf\ni -Inf\n'
    for doc in (text, extra):
        mine, ref = parse_prometheus(doc), jm.parse_prometheus(doc)
        assert json.dumps(mine, sort_keys=True) == \
            json.dumps(ref, sort_keys=True)
    for bad in ("this is { not exposition\n", 'm{a="never closed\n',
                "g not_a_number\n"):
        with pytest.raises(ValueError, match="malformed|unterminated"):
            parse_prometheus(bad)


def test_metrics_doc_renders_the_reference_table():
    """The port's doc renders the same table and count as the reference's;
    only the header, which names the package, differs."""
    mine, ref = tdoc.render(), jdoc.render()
    assert "repro_torch" in mine.split("| metric |")[0]
    assert mine.split("| metric |", 1)[1] == ref.split("| metric |", 1)[1]


# ---------------------------------------------------------------------------
# Trace recorder
# ---------------------------------------------------------------------------

def _record(rec_cls, arr):
    rec = rec_cls()
    rec.admit(0, 0, label=3, num_steps=4, engine_step=0)
    active = np.array([True, False])
    snaps = [{"steps_reused": arr([0.0, 0.0]),
              "blocks_computed": arr([4.0, 4.0]),
              "blocks_skipped": arr([0.0, 0.0]),
              "audit_err_sum": arr([0.0, 0.0]),
              "audit_steps": arr([0.0, 0.0])},
             {"steps_reused": arr([1.0, 0.0]),
              "blocks_computed": arr([6.0, 4.0]),
              "blocks_skipped": arr([2.0, 0.0]),
              "audit_err_sum": arr([0.3, 0.0]),
              "audit_steps": arr([2.0, 0.0])}]
    for step, st in enumerate(snaps, 1):
        with rec.step_begin(step, active=1):
            pass
        rec.snapshot_slots(step, active, st)
    rec.finish(0, engine_step=2, stats={"steps_reused": 1.0})
    return rec.to_json()


def _shape(doc):
    """Each event without its host-clock stamps (ts, dur)."""
    return [(e["name"], e["ph"], e.get("tid"), e.get("cat"),
             e.get("args", {})) for e in doc["traceEvents"]]


def test_trace_documents_pass_both_validators(tmp_path):
    """The same events recorded by both packages: the port's document
    passes both validators and carries the reference's events, args and
    counter values (timestamps are host clocks)."""
    mine = _record(TraceRecorder, lambda v: torch.tensor(v))
    ref = _record(jtracing.TraceRecorder,
                  lambda v: jnp.asarray(v, jnp.float32))
    validate_trace(mine)
    jtracing.validate_trace(mine)
    assert _shape(mine) == _shape(ref)
    names = [e["name"] for e in mine["traceEvents"]]
    assert "denoise (cache reuse)" in names and "serve_step" in names
    assert mine["displayTimeUnit"] == "ms"
    rec = TraceRecorder()
    rec.write(str(tmp_path / "t.json"))
    validate_trace(json.loads((tmp_path / "t.json").read_text()))
    for bad in ({"events": []},
                {"traceEvents": [{"name": "x", "ph": "X", "pid": 0}]},
                {"traceEvents": [{"name": "x", "ph": "Z", "pid": 0}]},
                {"traceEvents": [{"name": "x", "ph": "C", "pid": 0,
                                  "ts": 1.0}]}):
        with pytest.raises(ValueError):
            validate_trace(bad)


# ---------------------------------------------------------------------------
# A served trace's metrics against the reference engine's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """The same Poisson trace (2 slots, steps 4/6, guidance 1.0/4.0)
    through both engines with collectors (windows every 3 steps) and
    tracers; the port takes the reference's initial noise."""
    jcfg, jmodel, jparams = jax_dit("smoke")
    model = port_dit(jcfg, jparams)
    ncls = jcfg.dit.num_classes
    jcol = jm.MetricsCollector(window_steps=3)
    jeng = JEngine(JCachedDiT(jmodel, JFastCacheConfig()), jparams,
                   max_slots=2, num_steps=6, max_steps=6, collector=jcol,
                   tracer=jtracing.TraceRecorder())
    jdone = jeng.run(jpoisson_trace(num_classes=ncls, **TRACE))
    col = MetricsCollector(window_steps=3)
    tracer = TraceRecorder()
    eng = DiffusionServingEngine(
        CachedDiT(model, FastCacheConfig()), max_slots=2, num_steps=6,
        max_steps=6, collector=col, tracer=tracer,
        noise_fn=lambda r: t32(np.asarray(jeng.request_noise(r))))
    done = eng.run(poisson_trace(num_classes=ncls, **TRACE))
    return jeng, jcol, jdone, eng, col, tracer, done


def test_served_metrics_equal_reference(served):
    jeng, jcol, jdone, eng, col, _, done = served
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert len(col.windows) == len(jcol.windows) >= 3
    for w, jw in zip(col.windows, jcol.windows):
        assert w["at_step"] == jw["at_step"]
        assert w["counters"] == jw["counters"]
        assert w["per_slot"] == jw["per_slot"]
        assert set(w["histograms"]) == set(jw["histograms"])
        for name, h in jw["histograms"].items():
            assert w["histograms"][name]["bucket_counts"] == \
                h["bucket_counts"], name
            np.testing.assert_allclose(w["histograms"][name]["sum"],
                                       h["sum"], rtol=1e-4)
            assert w["histograms"][name]["count"] == h["count"]
    totals = col.totals()
    assert totals[tm.SERVE_STEPS] == eng.model_steps
    assert totals[tm.REQUESTS_FINISHED] == len(done)
    parse_prometheus(col.to_prometheus())


def test_served_trace_validates(served):
    *_, tracer, done = served
    doc = tracer.to_json()
    validate_trace(doc)
    jtracing.validate_trace(doc)
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("admit") == names.count("finish") == len(done)
    assert any(n.startswith("denoise") for n in names)


def test_engine_metrics_disabled_is_supported():
    jcfg, _, jparams = jax_dit("smoke")
    model = port_dit(jcfg, jparams)
    eng = DiffusionServingEngine(CachedDiT(model, FastCacheConfig()),
                                 max_slots=2, num_steps=3,
                                 enable_metrics=False)
    assert eng.metrics == {}
    done = eng.run(poisson_trace(2, 1.0, seed=0, num_classes=10))
    assert len(done) == 2 and eng.harvest_metrics() is None
