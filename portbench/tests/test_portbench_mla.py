"""The latent attention's readers, ``mla_share.serve`` and
``mla_kernel_share.serve``, on hand-built profiler traces: kernels launched
inside and outside the program's ``btia.lm.attn`` spans, on the loop
thread and on another, a span with the packed-token attention kernel and
one with the grid code's kernels; a trace of a program without that kernel
(0) and one without the spans (nothing)."""

import pytest

from portbench.bench import Registry
from portbench.trace import WINDOW, Trace


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def launch(events, name, corr, at, start, dur, tid=1):
    """A launch on thread `tid` at `at` and its kernel `name` on [start,
    start + dur)."""
    events.append(ev("cudaLaunchKernel", "cuda_runtime", at, 2, tid=tid, correlation=corr))
    events.append(ev(name, "kernel", start, dur, tid=7, correlation=corr))


def mla_trace(kernel: str = "void (anonymous namespace)::mla_attn_kernel(MaParams)"):
    """A 1000 us window. Span [100, 300): the projection GEMM (50 us) and
    the attention kernel `kernel` (40 us). Span [500, 700): the grid code's
    scatter and f32 GEMM (90 + 30 us). Outside the spans: a MoE kernel (100
    us) and, on thread 2 during the first span, a kernel of another launch
    (20 us)."""
    ev_ = [ev(WINDOW, "user_annotation", 0, 1000), ev("btia.lm.attn", "user_annotation", 100, 200),
           ev("btia.lm.attn", "user_annotation", 500, 200)]
    launch(ev_, "gemm_bias_ws_kernel", 1, 120, 130, 50)
    launch(ev_, kernel, 2, 190, 200, 40)
    launch(ev_, "index_elementwise_kernel", 3, 510, 520, 90)
    launch(ev_, "sm80_xmma_gemm_f32f32", 4, 560, 615, 30)
    launch(ev_, "moe_gemm_kernel", 5, 790, 800, 100)
    launch(ev_, "elementwise_kernel", 6, 150, 950, 20, tid=2)
    return Trace(ev_)


def test_mla_share_counts_the_kernels_launched_inside_the_spans():
    reg = Registry()
    t = mla_trace()
    assert t.busy_s == pytest.approx(330e-6)
    assert reg.reader("mla_share.serve")({"trace": t}) == pytest.approx(100 * (50 + 40 + 90 + 30) / 330)


@pytest.mark.parametrize("kernel, share", [("void (anonymous namespace)::mla_attn_kernel(MaParams)", 50.0),
                                           ("void at::native::elementwise_kernel<128, 2>", 0.0)])
def test_mla_kernel_share_counts_the_spans_the_kernel_launched_in(kernel, share):
    """One span of two launched the kernel; a program without it (the grid
    code in both) reads 0."""
    assert Registry().reader("mla_kernel_share.serve")({"trace": mla_trace(kernel)}) == pytest.approx(share)


def test_the_mla_readers_find_nothing_without_the_spans():
    bare = Trace([e for e in mla_trace().events if e["name"] != "btia.lm.attn"])
    no_device = Trace([e for e in mla_trace().events if e["cat"] != "kernel"])
    reg = Registry()
    for name in ("mla_share.serve", "mla_kernel_share.serve"):
        for t in (bare, no_device):
            assert reg.reader(name)({"trace": t}) is None, name
        assert reg.reader(name)({}) is None, name
