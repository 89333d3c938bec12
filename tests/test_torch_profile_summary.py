"""``chip_smoke.kineto_averages`` against ``torch.profiler``'s own
``key_averages()`` on the CPU.

``chip_smoke.py`` summarises its profiled epochs (the ``profile`` and
``profile_wire`` lines: the top host ops and device kernels) from the
profiler's kineto events rather than through ``key_averages()``, which
takes about a minute on a training epoch.  Here a few small profiled runs
must give, name by name, the same rows: the same names, the same call
counts and the same self CPU time (to 1e-3 µs, float rounding of sums in
another order).
"""
import importlib.util
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)   # for its dataclasses
    spec.loader.exec_module(mod)
    return mod


def _train_steps():
    """Forward, backward and an optimizer step of a small MLP, three
    profiler steps after one of warm-up (``ProfilerStep#n`` events)."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.GELU(),
                            torch.nn.Linear(64, 4))
    opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
    x = torch.randn(16, 32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=4)) as prof:
        for _ in range(4):
            with torch.profiler.record_function("step"):
                loss = (m(x) * 2.0).pow(2).mean()
                opt.zero_grad()
                loss.backward()
                opt.step()
            prof.step()
    return prof


def _nested_same_name():
    """A range whose only child has its own name (folded into it by
    ``key_averages()``), one with two such children (not folded), and
    in-place updates of a leaf that requires grad."""
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    w = torch.zeros(8, requires_grad=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with torch.profiler.record_function("fold"):
                with torch.profiler.record_function("fold"):
                    torch.mm(a, b)
            with torch.profiler.record_function("pair"):
                with torch.profiler.record_function("pair"):
                    torch.mm(a, b)
                with torch.profiler.record_function("pair"):
                    torch.add(a, b)
            (w * a.sum()).sum().backward()
            with torch.no_grad():
                w.sub_(w.grad)
            w.grad = None
    return prof


@pytest.mark.parametrize("run", [_train_steps, _nested_same_name],
                         ids=["train_steps", "nested_same_name"])
def test_kineto_averages_match_key_averages(chip_smoke, run):
    prof = run()
    want = {e.key: e for e in prof.key_averages()}
    got = {e.key: e for e in chip_smoke.kineto_averages(prof)}
    assert set(got) == set(want) and len(want) > 3
    assert not any(e.on_device for e in got.values())
    for key, w in want.items():
        g = got[key]
        assert g.count == w.count, key
        assert g.self_cpu_time_total == pytest.approx(
            w.self_cpu_time_total, abs=1e-3), key
