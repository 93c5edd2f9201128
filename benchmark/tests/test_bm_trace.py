"""The trace reader on a hand-made Chrome trace: the stretch, busy time per
card, scope time on one thread, kernels tied to the calls that launched
them, idle gaps by the host's scope."""

import json

import pytest

from benchmark import tracefile


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


@pytest.fixture
def trace(tmp_path):
    ev = [
        _x("user_annotation", "bm.stretch", 9, 100.0, 1000.0),
        _x("user_annotation", "iter.wait", 1, 50.0, 150.0),    # clipped
        _x("user_annotation", "iter.wait", 1, 600.0, 100.0),
        _x("user_annotation", "iter.wait", 2, 600.0, 100.0),   # not main
        _x("user_annotation", "fused", 2, 100.0, 400.0),
        _x("user_annotation", "step.minimize", 2, 150.0, 200.0),
        _x("user_annotation", "bm.call#7", 2, 380.0, 20.0),
        _x("user_annotation", "bm.call#8", 3, 500.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 390.0, 2.0,
           correlation=11),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 505.0, 2.0,
           correlation=12),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 200.0, 2.0,
           correlation=13),
        # K1 of call 7, on card 0.
        _x("kernel", "void lis_chain_kernel<1>(int)", 7, 400.0, 100.0,
           device=0, correlation=11),
        # K2 of call 8 carries an External id that no call has.
        _x("kernel", "void band_reg_kernel<false, true>(BandArgs)", 7,
           450.0, 150.0, device=0, correlation=12, **{"External id": 3}),
        # A torch kernel: busy time, tied to no call.
        _x("kernel", "elementwise", 8, 300.0, 50.0, device=1,
           correlation=13),
        _x("gpu_user_annotation", "fused", 7, 0.0, 2000.0, device=0),
        _x("kernel", "late", 7, 2000.0, 10.0, device=0),
    ]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return tracefile.Trace(str(p), main_tid=1)


def test_stretch_and_busy(trace):
    assert trace.seconds == pytest.approx(1000e-6)
    busy = trace.busy_s()
    assert busy[0] == pytest.approx(200e-6)          # 400-600 merged
    assert busy[1] == pytest.approx(50e-6)
    assert trace.device_ops(2)[0][0].startswith("void band_reg")


def test_scope_time(trace):
    assert trace.scope_s("iter.wait", 1) == pytest.approx(200e-6)
    assert trace.scope_s("iter.wait") == pytest.approx(200e-6)  # union


def test_kernels_tied_to_calls(trace):
    assert trace.call_kernel_s() == {7: pytest.approx(100e-6),
                                     8: pytest.approx(150e-6)}


def test_idle_gaps(trace):
    gaps = dict(trace.idle_gaps([0]))
    # Card 0 idles 100-400 and 600-1100: at 250 the host was in
    # step.minimize (inside fused), at 850 in nothing.
    assert gaps["step.minimize"] == pytest.approx(300e-6)
    assert gaps["(no scope)"] == pytest.approx(500e-6)
