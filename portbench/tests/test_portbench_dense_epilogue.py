"""``dense_epilogue_share.serve`` on synthetic profiler traces: the Dense
calls inside which the epilogue GEMM (``gemm_bias_ws_kernel``) launched,
over every Dense call of the window, attributed by correlation id."""

import pytest

from portbench.bench import Registry
from portbench.trace import WINDOW, Trace


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def trace(epilogue_calls, chain_calls):
    """A window of Dense calls: each epilogue call launches one
    gemm_bias_ws_kernel; each chain call a library GEMM and a bias add."""
    dense = "portbench.dense|2048|768|3072|2"
    events, ts, corr = [ev(WINDOW, "user_annotation", 0, 100000)], 10, 1
    for i in range(epilogue_calls + chain_calls):
        kernels = ["void gemm_bias_ws_kernel<256, false, 1>(CUtensorMap)"] if i < epilogue_calls \
            else ["nvjet_tst_192x192", "elementwise_kernel_128"]
        events.append(ev(dense, "user_annotation", ts, 50))
        for k in kernels:
            events.append(ev("cudaLaunchKernel", "cuda_runtime", ts + 5, 2, correlation=corr))
            events.append(ev(k, "kernel", ts + 100, 30, tid=7, correlation=corr))
            corr += 1
        ts += 200
    # K1/K2's projection GEMM, outside any Dense range, counts for nothing
    events.append(ev("cudaLaunchKernel", "cuda_runtime", ts + 5, 2, correlation=corr))
    events.append(ev("void gemm_bias_ws_kernel<256, true, 0>(CUtensorMap)", "kernel", ts + 100, 30, tid=7,
                     correlation=corr))
    return Trace(events)


@pytest.mark.parametrize("epilogue,chain,share", [(92, 1, 100 * 92 / 93), (0, 93, 0.0), (5, 0, 100.0)])
def test_share_of_dense_calls_on_the_epilogue_gemm(epilogue, chain, share):
    read = Registry().reader("dense_epilogue_share.serve")
    assert read({"trace": trace(epilogue, chain)}) == pytest.approx(share)


def test_nothing_to_read_without_device_events_or_dense_calls():
    read = Registry().reader("dense_epilogue_share.serve")
    assert read({"trace": Trace([ev(WINDOW, "user_annotation", 0, 1000)])}) is None
    no_dense = Trace([ev(WINDOW, "user_annotation", 0, 1000), ev("k", "kernel", 10, 5, tid=7, correlation=1)])
    assert read({"trace": no_dense}) is None
    assert read({}) is None
