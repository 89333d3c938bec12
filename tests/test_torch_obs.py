"""Port parity for observability: a twin of every case of
``tests/test_obs.py`` on ``repro_torch.obs`` and the port's engine, the
two packages' streams held to each other, and the bitwise-inert contract
inside the port.

Tolerances:
* event streams, span trees, compile causes, monitor gauges and watchdog
  firings on the same record sequences: exact (plain Python on both
  sides; the JSONL meta line's ``unix_time`` aside);
* per-link ``wire_bytes`` counters and the robust screens' per-server
  ``screen_rejected`` histograms from the two engines on the same
  scenario: exact (host numpy, the ``screen_rejected`` columns of
  ``tests/test_torch_robust.py``);
* the consensus replay against the reference's: rtol/atol 1e-5 (f32
  gossip summed in another order, ``tests/test_torch_consensus.py``'s);
* histories and final states with the full bundle against ``OBS_OFF``
  inside the port: bitwise.
"""
import io
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core import dfl as jdfl  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data import RegressionSpec as JSpec  # noqa: E402
from repro.data import make_regression_task as j_task  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.comm import prng  # noqa: E402
from repro_torch.core import (FaultEvent, FaultSchedule,  # noqa: E402
                              FLTopology,
                              ParticipationSchedule, TopologySchedule,
                              init_dfl_state, make_engine)
from repro_torch.core import dfl as tdfl  # noqa: E402
from repro_torch.core.engine import device_get, device_sync  # noqa: E402
from repro_torch.core.schedule import ByzantineSchedule  # noqa: E402
from repro_torch.data import RegressionSpec, make_regression_task  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.obs import (OBS_OFF, SCHEMA_VERSION, ConsoleSink,  # noqa: E402
                             ConvergenceMonitor, JSONLSink, MemorySink,
                             MetricsHub, Observability, Tracer, load_jsonl,
                             validate_chrome_trace, validate_jsonl)
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LM = dict(servers=4, clients=2, t_client=1, t_server=3, seq_len=16,
          device="cpu", log=False)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These runs are many small ops: one intra-op thread, so that parallel
    test workers do not oversubscribe the cores with spinning pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tracer: spans, nesting, Chrome export
# ---------------------------------------------------------------------------


def _fake_clock():
    """Deterministic injectable clock: 0, 10, 20, ... nanoseconds."""
    t = {"now": -10}

    def clock():
        t["now"] += 10
        return t["now"]
    return clock


def test_span_nesting_and_ordering_invariants():
    tr = Tracer(clock=_fake_clock())
    with tr.span("epoch", epoch=0) as outer:
        with tr.span("local-period"):
            pass
        with tr.span("gossip-period"):
            pass
    # children appended at EXIT, before the outer span closes
    names = [s.name for s in tr.spans]
    assert names == ["local-period", "gossip-period", "epoch"]
    local, gossip, epoch = tr.spans
    assert epoch is outer
    assert epoch.encloses(local) and epoch.encloses(gossip)
    assert local.t1_ns <= gossip.t0_ns
    assert all(s.duration_ns >= 0 for s in tr.spans)
    assert epoch.depth == 0 and local.depth == 1 and gossip.depth == 1
    assert local.parent is epoch and gossip.parent is epoch
    assert epoch.args == {"epoch": 0}


def test_add_span_places_explicit_intervals():
    tr = Tracer(clock=_fake_clock())
    with tr.span("epoch") as ep:
        pass
    sp = tr.add_span("gossip-period", ep.t0_ns, ep.t1_ns, parent=ep,
                     method="consensus-replay")
    assert ep.encloses(sp) and sp.depth == ep.depth + 1
    with pytest.raises(ValueError):
        tr.add_span("bad", 100, 50)


def test_chrome_trace_export_is_valid_and_complete():
    tr = Tracer(clock=_fake_clock())
    with tr.span("epoch", epoch=3):
        with tr.span("fault-surgery"):
            pass
    tr.compile_event("first_trace", m=4)
    doc = tr.to_chrome()
    events = validate_chrome_trace(doc)
    assert doc["displayTimeUnit"] == "ms"
    xs = [e for e in events if e["ph"] == "X"]
    insts = [e for e in events if e["ph"] == "i"]
    assert {e["name"] for e in xs} == {"epoch", "fault-surgery"}
    assert [e["name"] for e in insts] == ["compile"]
    assert insts[0]["args"] == {"cause": "first_trace", "m": 4}
    assert [e["ts"] for e in xs] == sorted(e["ts"] for e in xs)
    # non-JSON-serialisable args are stringified, never dropped
    with tr.span("epoch", arr=torch.zeros(2)):
        pass
    json.dumps(tr.to_chrome())


def test_validate_chrome_trace_rejects_malformed():
    with pytest.raises(ValueError):
        validate_chrome_trace({"events": []})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"name": "x", "ph": "Z",
                                                "ts": 0}]})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"name": "x", "ph": "X",
                                                "ts": 0}]})  # no dur


def test_save_chrome_round_trips(tmp_path):
    tr = Tracer(clock=_fake_clock())
    with tr.span("epoch"):
        pass
    p = tmp_path / "trace.json"
    tr.save_chrome(str(p))
    validate_chrome_trace(json.loads(p.read_text()))


# ---------------------------------------------------------------------------
# hub + sinks: fan-out, JSONL schema round-trip
# ---------------------------------------------------------------------------


def test_sink_fanout_every_sink_sees_every_event(capsys):
    mem1, mem2 = MemorySink(), MemorySink()
    buf = io.StringIO()
    hub = MetricsHub([mem1, ConsoleSink()])
    hub.add_sink(mem2)
    hub.add_sink(JSONLSink(buf))
    hub.observe_epoch(0, {"loss": 1.5, "disagreement": 2e-4})
    hub.counter("wire_bytes", 100.0, epoch=0, src=1, dst=0)
    hub.warning("nan-loss", "loss is non-finite", epoch=0)
    hub.close()
    for mem in (mem1, mem2):
        assert mem.history() == {"loss": [1.5], "disagreement": [2e-4]}
        assert mem.totals() == {"wire_bytes": 100.0}
        assert [w.name for w in mem.warnings()] == ["nan-loss"]
    out = capsys.readouterr().out
    assert "epoch    0" in out and "loss=1.5000" in out
    assert "[obs:warn] nan-loss" in out
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert lines[0]["kind"] == "meta"
    assert [r["kind"] for r in lines[1:]] == ["epoch", "counter", "warning"]


def test_console_sink_respects_log_every(capsys):
    hub = MetricsHub([ConsoleSink(log_every=3)])
    for e in range(7):
        hub.observe_epoch(e, {"loss": float(e)})
    out = capsys.readouterr().out
    printed = [line for line in out.splitlines() if line.startswith("epoch")]
    assert len(printed) == 3          # epochs 0, 3, 6


def test_jsonl_schema_round_trip(tmp_path):
    p = tmp_path / "telemetry.jsonl"
    hub = MetricsHub([JSONLSink(str(p), run_info={"driver": "test"})])
    hub.observe_epoch(0, {"loss": 2.0, "sigma_prod": 0.5})
    hub.gauge("tolerance_gap", 3.5, epoch=0)
    hub.histogram("screen_rejected", [0.0, 2.0, 1.0], epoch=0,
                  servers=[0, 1, 2])
    hub.counter("wire_bytes", 42.0, epoch=0, src=2, dst=1)
    hub.close()
    records = load_jsonl(str(p))
    assert records[0] == {"kind": "meta", "schema": SCHEMA_VERSION,
                          "unix_time": records[0]["unix_time"],
                          "run": {"driver": "test"}}
    events = validate_jsonl(records)
    by_kind = {e["kind"]: e for e in events}
    assert by_kind["epoch"]["value"] == {"loss": 2.0, "sigma_prod": 0.5}
    assert by_kind["gauge"] == {"kind": "gauge", "name": "tolerance_gap",
                                "value": 3.5, "epoch": 0}
    assert by_kind["histogram"]["value"] == [0.0, 2.0, 1.0]
    assert by_kind["histogram"]["labels"] == {"servers": [0, 1, 2]}
    assert by_kind["counter"]["labels"] == {"src": 2, "dst": 1}


def test_validate_jsonl_rejects_bad_streams():
    meta = {"kind": "meta", "schema": SCHEMA_VERSION}
    with pytest.raises(ValueError):
        validate_jsonl([])
    with pytest.raises(ValueError):
        validate_jsonl([{"kind": "epoch", "name": "epoch", "value": {}}])
    with pytest.raises(ValueError):
        validate_jsonl([{"kind": "meta", "schema": SCHEMA_VERSION + 1}])
    with pytest.raises(ValueError):
        validate_jsonl([meta, {"kind": "spam", "name": "x", "value": 1}])
    with pytest.raises(ValueError):
        validate_jsonl([meta, {"kind": "gauge", "name": "g", "value": [1]}])
    with pytest.raises(ValueError):
        validate_jsonl([meta, {"kind": "histogram", "name": "h",
                               "value": 1.0}])


# ---------------------------------------------------------------------------
# convergence monitor: derived gauges + watchdog rules
# ---------------------------------------------------------------------------


def test_monitor_gauges_track_paper_quantities():
    hub = MetricsHub([MemorySink()])
    events = []
    hub.gauge = lambda name, value, *, epoch=None, **kw: \
        events.append((name, value, epoch))  # capture without a sink walk
    mon = ConvergenceMonitor(hub)
    mon.observe(0, {"loss": 1.0, "disagreement": 0.5, "sigma_prod": 0.8})
    mon.observe(1, {"loss": 0.9, "disagreement": 0.1, "sigma_prod": 0.4})
    gaps = [v for n, v, _ in events if n == "tolerance_gap"]
    bounds = [v for n, v, _ in events if n == "contraction_bound"]
    assert gaps == [0.5 / 1e-3, 0.1 / 1e-3]
    # d0 is the FIRST disagreement; the bound contracts with sigma_prod
    assert bounds == [0.8 * 0.5, 0.4 * 0.5]


def test_watchdog_nan_loss_fires_once():
    mem = MemorySink()
    mon = ConvergenceMonitor(MetricsHub([mem]))
    mon.observe(0, {"loss": 1.0, "disagreement": 1e-4})
    assert mon.events == []
    mon.observe(1, {"loss": float("nan"), "disagreement": 1e-4})
    mon.observe(2, {"loss": float("inf"), "disagreement": 1e-4})
    assert [e.rule for e in mon.events] == ["nan-loss"]
    assert mon.events[0].epoch == 1
    assert [w.name for w in mem.warnings()] == ["nan-loss"]


def test_watchdog_disagreement_divergence():
    mon = ConvergenceMonitor(MetricsHub([MemorySink()]),
                             divergence_window=3)
    dis = [1e-4, 1e-4, 1e-4, 1e-4, 5e-2]     # 500x jump over the window
    for e, d in enumerate(dis):
        mon.observe(e, {"loss": 1.0, "disagreement": d})
    assert [e.rule for e in mon.events] == ["disagreement-divergence"]
    assert mon.events[0].value == pytest.approx(5e-2)


def test_watchdog_wire_ratio_regression():
    mon = ConvergenceMonitor(MetricsHub([MemorySink()]))
    mon.observe(0, {"loss": 1.0, "wire_ratio": 4.0})
    mon.observe(1, {"loss": 1.0, "wire_ratio": 3.5})   # mild dip: no fire
    assert mon.events == []
    mon.observe(2, {"loss": 1.0, "wire_ratio": 1.0})   # collapsed
    assert [e.rule for e in mon.events] == ["wire-ratio-regression"]


# ---------------------------------------------------------------------------
# the Observability bundle + the bitwise-inert contract
# ---------------------------------------------------------------------------


def test_obs_off_is_a_complete_null_object():
    assert OBS_OFF.enabled is False
    with OBS_OFF.span("epoch", epoch=0) as sp:
        assert sp is None
    OBS_OFF.compile_event("first_trace")
    OBS_OFF.observe(0, {"loss": 1.0}, servers=(0,), per_link=None)
    OBS_OFF.close()


def test_observability_labels_per_link_and_screen():
    mem = MemorySink()
    obs = Observability(hub=MetricsHub([mem]), tracer=Tracer(),
                        monitor=True)
    per_link = [[0.0, 7.0], [3.0, 0.0]]
    obs.observe(0, {"loss": 1.0, "disagreement": 1e-4},
                servers=(0, 2),              # dense rows -> original ids
                per_link=per_link, screen_rejected=[1.0, 0.0])
    obs.close()
    assert mem.totals() == {"wire_bytes": 10.0}
    assert mem.history()["loss"] == [1.0]
    assert obs.monitor is not None and obs.monitor.events == []


FAULTS = ((2, "drop", 1), (4, "rejoin", 1))


def _small_engine(obs=None, faults=FAULTS, superepoch=1, m=3, **cfg_kw):
    """The reference test's scenario: M = 3 ring, N = 2, T_C = 2, T_S = 3,
    Bernoulli(0.7), edge drops 0.3."""
    topo = FLTopology(num_servers=m, clients_per_server=2, t_client=2,
                      t_server=3, graph_kind="ring")
    task = make_regression_task(topo, RegressionSpec(heterogeneity=0.5),
                                seed=0)
    opt = sgd(1e-3)
    eng = make_engine(topo, task["loss_fn"], opt,
                      participation=ParticipationSchedule(
                          kind="bernoulli", rate=0.7, seed=3),
                      topology_schedule=TopologySchedule(
                          kind="edge_drop", drop_prob=0.3, seed=4),
                      faults=FaultSchedule(tuple(FaultEvent(*f)
                                                 for f in faults)),
                      obs=obs, superepoch=superepoch, **cfg_kw)
    state = init_dfl_state(eng.cfg, torch.zeros(2), opt,
                           wire_key=prng.key(0))
    return eng, state, task["batch_fn"]


def _j_small_engine(obs=None, faults=FAULTS, superepoch=1, m=3, **cfg_kw):
    topo = J.FLTopology(num_servers=m, clients_per_server=2, t_client=2,
                        t_server=3, graph_kind="ring")
    task = j_task(topo, JSpec(heterogeneity=0.5), seed=0)
    opt = j_sgd(1e-3)
    eng = J.make_engine(topo, task["loss_fn"], opt,
                        participation=jsched.ParticipationSchedule(
                            kind="bernoulli", rate=0.7, seed=3),
                        topology_schedule=jsched.TopologySchedule(
                            kind="edge_drop", drop_prob=0.3, seed=4),
                        faults=jsched.FaultSchedule(tuple(
                            jsched.FaultEvent(*f) for f in faults)),
                        obs=obs, superepoch=superepoch, **cfg_kw)
    state = J.init_dfl_state(eng.cfg, jnp.zeros((2,)), opt,
                             jax.random.key(0))
    return eng, state, task["batch_fn"]


def _full_bundle():
    return Observability(hub=MetricsHub([MemorySink()]), tracer=Tracer(),
                         monitor=True)


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert x == y or (math.isnan(x) and math.isnan(y)), \
                f"obs changed {k}: {x!r} != {y!r}"


def test_engine_history_bitwise_identical_with_obs_on():
    """The load-bearing contract: the FULL bundle (hub + sinks + tracer
    with its sync points and replay probes + monitor) leaves every bit of
    every metric as it is."""
    def run(obs):
        eng, state, batch_fn = _small_engine(obs=obs)
        hist = {}
        for e in range(6):
            state, rec = eng.run_epoch(state, e, batch_fn)
            for k, v in rec.items():
                hist.setdefault(k, []).append(v)
        return hist

    _assert_bitwise(run(None), run(_full_bundle()))


def test_engine_emits_spans_and_compile_events():
    tracer = Tracer()
    mem = MemorySink()
    obs = Observability(hub=MetricsHub([mem]), tracer=tracer, monitor=True)
    eng, state, batch_fn = _small_engine(obs=obs, faults=((2, "drop", 1),))
    for e in range(4):
        state, _ = eng.run_epoch(state, e, batch_fn)
    names = {s.name for s in tracer.spans}
    assert {"epoch", "local-period", "gossip-period", "fault-surgery",
            "host-aggregation"} <= names
    epochs = [s for s in tracer.spans if s.name == "epoch"]
    assert len(epochs) == 4
    for ep in epochs:
        kids = [s for s in tracer.spans if s.parent is ep]
        assert kids and all(ep.encloses(k) for k in kids)
    causes = [ev["args"]["cause"] for ev in tracer.instants
              if ev["name"] == "compile"]
    # M = 3 first, then the fault surgery builds the step of M = 2
    assert causes == ["first_trace", "federation_size_change"]
    assert eng.compile_counts() == {3: 1, 2: 1}
    validate_chrome_trace(tracer.to_chrome())
    assert len(mem.history()["loss"]) == 4


# ---------------------------------------------------------------------------
# cross-package parity: files, events, monitor, spans, labels
# ---------------------------------------------------------------------------


def _stream(pkg, records, **kw):
    """Each record (epoch, record, observe kw) through ``pkg``'s bundle with
    a JSONL sink and the monitor: the decoded lines."""
    buf = io.StringIO()
    hub = pkg.MetricsHub([pkg.JSONLSink(buf, run_info={"driver": "t"})])
    obs = pkg.Observability(hub=hub,
                            monitor=pkg.ConvergenceMonitor(hub, **kw))
    for epoch, rec, okw in records:
        obs.observe(epoch, rec, **okw)
    obs.close()
    return [json.loads(line) for line in buf.getvalue().splitlines()]


RECORDS = [
    (0, {"loss": 2.0, "disagreement": 0.5, "sigma_prod": 0.8,
         "wire_ratio": 4.0, "num_servers": 3.0},
     dict(servers=(0, 1, 2), per_link=np.array([[0, 5, 0], [5, 0, 7],
                                                [0, 7, 0]]),
          screen_rejected=np.array([0.0, 1.5, 0.5], np.float32))),
    (1, {"loss": 1.5, "disagreement": 1e-4, "sigma_prod": 0.3,
         "wire_ratio": 3.9, "num_servers": 2.0},
     dict(servers=(0, 2), per_link=[[0.0, 3.0], [3.0, 0.0]])),
    (2, {"loss": float("nan"), "disagreement": 2e-4, "sigma_prod": 0.1,
         "wire_ratio": 1.0, "num_servers": 2.0}, dict(servers=(0, 2))),
    (3, {"loss": 1.0, "disagreement": float("inf")}, {}),
]


@pytest.mark.parametrize("kw", [{}, {"divergence_window": 1,
                                     "wire_ratio_drop": 0.9}],
                         ids=["defaults", "tight"])
def test_same_records_give_the_reference_events(kw):
    """The same record sequence through both bundles: the same events line
    for line (gauges, watchdog warnings, per-link counters with original
    ids, histograms), the meta line's ``unix_time`` aside."""
    ours = _stream(tobs, RECORDS, **kw)
    theirs = _stream(jobs, RECORDS, **kw)
    assert ours[0].pop("unix_time") > 0 and theirs[0].pop("unix_time") > 0
    assert json.dumps(ours) == json.dumps(theirs)
    assert any(r["kind"] == "warning" for r in ours)


@pytest.mark.parametrize("seq", [
    [1e-4, 1e-4, 1e-4, 1e-4, 5e-2, float("nan")],
    [0.5, 0.2, 0.05, 0.01, 3.0, 40.0, 400.0],
    [float("inf"), 1e-3, 1e-2]], ids=["divergence", "growth", "inf_first"])
def test_monitor_matches_reference_on_the_same_sequences(seq):
    ours = ConvergenceMonitor(MetricsHub([MemorySink()]),
                              divergence_window=3)
    theirs = jobs.ConvergenceMonitor(jobs.MetricsHub([jobs.MemorySink()]),
                                     divergence_window=3)
    gauges = ([], [])
    for mon, out in ((ours, gauges[0]), (theirs, gauges[1])):
        mon.hub.gauge = (lambda out: lambda n, v, *, epoch=None, **k:
                         out.append((n, v, epoch)))(out)
    for e, d in enumerate(seq):
        rec = {"loss": 1.0, "disagreement": d, "sigma_prod": 0.5 ** e,
               "wire_ratio": 4.0 / (1 + e)}
        ours.observe(e, rec)
        theirs.observe(e, rec)
    assert gauges[0] == gauges[1]
    assert [(e.rule, e.epoch, e.message) for e in ours.events] == \
        [(e.rule, e.epoch, e.message) for e in theirs.events]
    assert all(a.value == b.value or (math.isnan(a.value)
                                      and math.isnan(b.value))
               for a, b in zip(ours.events, theirs.events))


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_files_cross_validate(direction, tmp_path):
    """The port's JSONL and Chrome trace pass the reference's validators,
    and the reference's pass the port's."""
    port_writes = direction == "port_to_reference"
    reader = jobs if port_writes else tobs
    jpath, cpath = tmp_path / "t.jsonl", tmp_path / "t.json"
    if port_writes:
        obs = Observability(hub=MetricsHub([JSONLSink(str(jpath))]),
                            tracer=Tracer(), monitor=True)
        eng, state, batch_fn = _small_engine(obs=obs, superepoch=2)
    else:
        obs = jobs.Observability(
            hub=jobs.MetricsHub([jobs.JSONLSink(str(jpath))]),
            tracer=jobs.Tracer(), monitor=True)
        eng, state, batch_fn = _j_small_engine(obs=obs, superepoch=2)
    eng.run(state, 6, batch_fn)
    obs.close()
    obs.tracer.save_chrome(str(cpath))
    events = reader.validate_jsonl(reader.load_jsonl(str(jpath)))
    assert sum(e["kind"] == "epoch" for e in events) == 6
    trace = reader.validate_chrome_trace(json.loads(cpath.read_text()))
    assert {"superepoch", "epoch", "gossip-round"} <= {e["name"]
                                                       for e in trace}


def _span_tree(tracer):
    keys = ("epoch", "method", "t_server", "round", "k")
    return ([(s.name, None if s.parent is None else s.parent.name,
              tuple(s.args.get(k) for k in keys)) for s in tracer.spans],
            [ev["args"] for ev in tracer.instants])


@pytest.mark.parametrize("superepoch", [1, 2])
def test_engine_spans_match_reference(superepoch):
    """Both engines on the same scenario (drop at 2, rejoin at 4): the same
    span names, parents and args (``method`` included: consensus-replay,
    uniform-split, calibrated, calibrated-round) in the same order, and
    the same compile events; under K = 2 the superepoch taxonomy."""
    ours, theirs = Tracer(), jobs.Tracer()
    eng, st, bf = _small_engine(obs=Observability(tracer=ours),
                                superepoch=superepoch)
    eng.run(st, 6, bf)
    jeng, jst, jbf = _j_small_engine(obs=jobs.Observability(tracer=theirs),
                                     superepoch=superepoch)
    jeng.run(jst, 6, jbf)
    spans, compiles = _span_tree(ours)
    assert (spans, compiles) == _span_tree(theirs)
    assert [c["cause"] for c in compiles] == ["first_trace",
                                              "federation_size_change"]
    if superepoch == 2:
        assert sum(s[0] == "superepoch" for s in spans) == 3
        assert sum(s[0] == "gossip-round" for s in spans) == 6 * 3
    for s in ours.spans:
        assert s.parent is None or s.parent.encloses(s)


def _events(buf):
    return [json.loads(line) for line in buf.getvalue().splitlines()[1:]]


def _engine_streams(m=3, faults=FAULTS, **cfg_kw):
    bufs = io.StringIO(), io.StringIO()
    eng, st, bf = _small_engine(
        obs=Observability(hub=MetricsHub([JSONLSink(bufs[0])])),
        m=m, faults=faults, **cfg_kw)
    eng.run(st, 6, bf)
    jeng, jst, jbf = _j_small_engine(
        obs=jobs.Observability(hub=jobs.MetricsHub([jobs.JSONLSink(
            bufs[1])])), m=m, faults=faults, **cfg_kw)
    jeng.run(jst, 6, jbf)
    return _events(bufs[0]), _events(bufs[1])


@pytest.mark.parametrize("wire", ["simulated", "physical"])
def test_wire_bytes_counters_match_reference(wire):
    """Per-link ``wire_bytes`` counters through drop/rejoin: dst and src
    are original server ids, the bytes the reference's, exactly."""
    ours, theirs = _engine_streams(m=4, compression="int8", wire=wire)
    pick = [[e for e in evs if e["name"] == "wire_bytes"]
            for evs in (ours, theirs)]
    assert pick[0] and pick[0] == pick[1]
    assert {e["labels"]["src"] for e in pick[0]} == {0, 1, 2, 3}


def test_screen_histogram_matches_reference():
    """``trimmed_mean:1`` with one sign-flipping server of four on K_4: the
    per-server ``screen_rejected`` histograms (per round, labelled with
    original ids) exactly the reference's, through a drop."""
    faults = ((3, "drop", 2),)
    kw = dict(consensus_mode="trimmed_mean:1", graph_kind="complete")
    bufs = io.StringIO(), io.StringIO()
    topo = FLTopology(num_servers=4, clients_per_server=2, t_client=2,
                      t_server=3, graph_kind=kw["graph_kind"])
    task = make_regression_task(topo, seed=0)
    eng = make_engine(topo, task["loss_fn"], sgd(1e-2),
                      consensus_mode=kw["consensus_mode"],
                      byzantine=ByzantineSchedule.parse("sign_flip:0.25",
                                                        seed=1),
                      faults=FaultSchedule(tuple(FaultEvent(*f)
                                                 for f in faults)),
                      obs=Observability(hub=MetricsHub([JSONLSink(
                          bufs[0])])))
    eng.run(init_dfl_state(eng.cfg, torch.zeros(2), sgd(1e-2)), 5,
            task["batch_fn"])
    jtopo = J.FLTopology(num_servers=4, clients_per_server=2, t_client=2,
                         t_server=3, graph_kind=kw["graph_kind"])
    jt = j_task(jtopo, seed=0)
    jeng = J.make_engine(
        jtopo, jt["loss_fn"], j_sgd(1e-2),
        consensus_mode=kw["consensus_mode"],
        byzantine=jsched.ByzantineSchedule.parse("sign_flip:0.25", seed=1),
        faults=jsched.FaultSchedule(tuple(jsched.FaultEvent(*f)
                                          for f in faults)),
        obs=jobs.Observability(hub=jobs.MetricsHub([jobs.JSONLSink(
            bufs[1])])))
    jeng.run(J.init_dfl_state(jeng.cfg, jnp.zeros((2,)), j_sgd(1e-2),
                              jax.random.key(0)), 5, jt["batch_fn"])
    hists = [[e for e in _events(b) if e["kind"] == "histogram"]
             for b in bufs]
    assert len(hists[0]) == 5 and hists[0] == hists[1]
    assert hists[0][-1]["labels"] == {"servers": [0, 1, 3]}
    assert max(hists[0][0]["value"]) > 0


@pytest.mark.parametrize("case", ["gossip", "chebyshev", "push_sum",
                                  "simulated_int8_ef", "physical_int8_ef"])
def test_consensus_replay_matches_reference(case):
    """``dfl.build_consensus_replay`` runs the reference's branches on the
    same server tree and A_p: the same mixed tree within TOL (compressed
    replays share the fixed key and the zero residual, so their codes are
    the reference's)."""
    kw = {"gossip": {}, "chebyshev": dict(consensus_mode="chebyshev"),
          "push_sum": dict(mixing="push_sum"),
          "simulated_int8_ef": dict(compression="int8:8",
                                    error_feedback=True),
          "physical_int8_ef": dict(compression="int8:8", wire="physical",
                                   error_feedback=True)}[case]
    shape = dict(num_servers=4, clients_per_server=2, t_client=1,
                 t_server=3, graph_kind="ring")
    rng = np.random.default_rng(0)
    tree = {"b": rng.standard_normal((4, 5)).astype(np.float32),
            "w": rng.standard_normal((4, 3, 7)).astype(np.float32)}
    a = FLTopology(**shape).mixing_matrix().astype(np.float32)
    lam2 = np.float32(0.6)
    ours = tdfl.build_consensus_replay(tdfl.DFLConfig(
        topology=FLTopology(**shape), dynamic=True, **kw))
    theirs = jdfl.build_consensus_replay(jdfl.DFLConfig(
        topology=J.FLTopology(**shape), dynamic=True, **kw))
    got = ours({k: torch.from_numpy(v.copy()) for k, v in tree.items()},
               torch.from_numpy(a), torch.tensor(lam2))
    want = theirs({k: jnp.asarray(v) for k, v in tree.items()},
                  jnp.asarray(a), jnp.float32(lam2))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)
    for m, t_s, mode in ((1, 3, "gossip"), (4, 0, "gossip"),
                         (4, 3, "none")):
        cfg = tdfl.DFLConfig(topology=FLTopology(
            **{**shape, "num_servers": m, "t_server": t_s}),
            consensus_mode=mode)
        assert tdfl.build_consensus_replay(cfg) is None


# ---------------------------------------------------------------------------
# inside the port: inertness on every path, the read-backs, the sync hook
# ---------------------------------------------------------------------------


PATHS = {"float": {},
         "physical_int8_ef": dict(m=4, compression="int8", wire="physical",
                                  error_feedback=True),
         "push_sum": dict(mixing="push_sum")}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("superepoch", [1, 3])
def test_full_bundle_is_bitwise_inert_through_drop_rejoin(path, superepoch):
    """Histories and the final state (client params, EF residual, wire
    key, push-sum weight) with the full bundle equal OBS_OFF's bit for
    bit, through drop and rejoin: the probe works on its own copy, key and
    residual."""
    runs = []
    for obs in (None, _full_bundle()):
        eng, st, bf = _small_engine(obs=obs, superepoch=superepoch,
                                    **PATHS[path])
        st, hist = eng.run(st, 6, bf)
        runs.append((st, hist, eng))
    (s0, h0, _), (s1, h1, eng) = runs
    _assert_bitwise(h0, h1)
    assert eng.obs.tracer.spans and eng._probes
    assert torch.equal(s0.client_params, s1.client_params)
    for a, b in ((s0.ef_residual, s1.ef_residual),
                 (s0.psum_weight, s1.psum_weight)):
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(tree_leaves(a), tree_leaves(b)):
                assert torch.equal(x, y)
    assert np.array_equal(s0.wire_key, s1.wire_key)


@pytest.mark.parametrize("superepoch", [1, 2])
def test_device_get_once_per_dispatch_with_the_bundle(superepoch):
    eng, st, bf = _small_engine(obs=_full_bundle(), superepoch=superepoch)
    calls = []

    def counted(tree):
        calls.append(1)
        return device_get(tree)

    eng._device_get = counted
    eng.run(st, 6, bf)
    assert len(calls) == len(eng._plan_blocks(6))


@pytest.mark.parametrize("bundle", ["off", "hub_only", "tracer"])
def test_sync_hook_runs_only_with_a_tracer(bundle):
    """The tracer's device sync is the only new sync: never under OBS_OFF
    or a hub without a tracer; with a tracer after every step and around
    every probe run."""
    obs = {"off": None,
           "hub_only": Observability(hub=MetricsHub([MemorySink()]),
                                     monitor=True),
           "tracer": _full_bundle()}[bundle]
    eng, st, bf = _small_engine(obs=obs)
    calls = []

    def counted(tree):
        calls.append(1)
        device_sync(tree)

    eng._sync = counted
    eng.run(st, 6, bf)
    if bundle == "tracer":
        # a step's sync, then two per probe run: six timed runs and the
        # warm-ups of M = 3 and M = 2
        assert len(calls) == 6 + 2 * (6 + 2)
    else:
        assert calls == []
        assert eng._probes == {}


def _check_files(jpath, cpath, epochs):
    events = validate_jsonl(load_jsonl(str(jpath)))
    assert sum(e["kind"] == "epoch" for e in events) == epochs
    assert jobs.validate_jsonl(jobs.load_jsonl(str(jpath)))
    trace = json.loads(cpath.read_text())
    names = {e["name"] for e in validate_chrome_trace(trace)}
    jobs.validate_chrome_trace(trace)
    return events, names


def test_train_writes_valid_files(tmp_path):
    jpath, cpath = tmp_path / "s.jsonl", tmp_path / "s.json"
    run = ttrain.train("smollm-360m", epochs=2, telemetry_jsonl=str(jpath),
                       chrome_trace=str(cpath), **LM)
    events, names = _check_files(jpath, cpath, 2)
    assert names == {"epoch"}
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert [e["value"]["loss"] for e in epochs] == run["history"]["loss"]
    assert "epoch_s" in epochs[0]["value"]
    assert isinstance(run["obs"], Observability)
    plain = ttrain.train("smollm-360m", epochs=2, **LM)
    for k in ("loss", "disagreement", "drift"):
        assert plain["history"][k] == run["history"][k], k


def test_train_dynamic_writes_valid_files(tmp_path):
    jpath, cpath = tmp_path / "d.jsonl", tmp_path / "d.json"
    kw = dict(LM, epochs=3, participation_rate=0.5, edge_drop_prob=0.3,
              faults="drop:1:2,rejoin:2:2")
    run = ttrain.train_dynamic("smollm-360m", telemetry_jsonl=str(jpath),
                               chrome_trace=str(cpath), **kw)
    events, names = _check_files(jpath, cpath, 3)
    assert {"epoch", "fault-surgery", "local-period", "gossip-period",
            "host-aggregation", "compile"} <= names
    plain = ttrain.train_dynamic("smollm-360m", **kw)
    for k in ("loss", "disagreement", "num_servers"):
        assert plain["history"][k] == run["history"][k], k
    assert run["history"]["num_servers"] == [4.0, 3.0, 4.0]


def test_cli_writes_valid_files_on_cpu(tmp_path, capsys):
    jpath, cpath = tmp_path / "c.jsonl", tmp_path / "c.json"
    ttrain.main(["--device", "cpu", "--servers", "4", "--clients", "2",
                 "--t-client", "1", "--t-server", "3", "--epochs", "2",
                 "--seq-len", "16", "--superepoch", "2",
                 "--telemetry-jsonl", str(jpath), "--chrome-trace",
                 str(cpath)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("epoch")]
    assert len(lines) == 2
    _, names = _check_files(jpath, cpath, 2)
    assert {"superepoch", "epoch", "gossip-round"} <= names
