#!/usr/bin/env python3
"""Time the port's K3, K4, K5, K6 and K1/K2's attention core and projection
GEMM against another checkout's on one card, in turns.

    git archive <commit> btia_tpu_torch | tar -x -C runs/parent
    python3 compare_kernels.py runs/parent

Builds both checkouts' kernel libraries (each from its own
``btia_tpu_torch/csrc``), then runs each kernel's C entry at the shapes of
``chip_smoke.py``'s phases 2 and 2b in the order parent, this tree, this
tree, parent, and prints both pairs of times (CUDA events, ms a call) with
the largest difference between the two outputs. K3's shapes are also timed
through K5's entry with K3's packed strides: the 4-D (B, H, S, D) tensor-map
path over the same bytes. K4 runs at the six training shapes and the four
serve shapes of ``chip_smoke.py``'s phase 2, K6 at phase 2b's two, K1/K2's
attention core (``btia_attn_core``) at the four serve site shapes (K2's with
one shared query table) and the train site shapes (BTIA img <- txt also at
D 128, 192 and 256); where the other checkout's K4 / K6 / core entry has an
earlier C signature (no strides or plan; the core's: the wmma kernel's
row strides and an f32 key mask, given the same mask as 0 / 1), it is
called that way. Inputs are random from a seed; the card's name
and power limit are printed first. Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

# K3: (B, Sq, Sk, heads, head width, masked): ViT-L, ViT-B, the AD head at
# D = 64, 128, 192, 256.
K3_SHAPES = ((16, 577, 577, 16, 64, False), (64, 197, 197, 12, 64, False), (64, 2048, 229, 12, 64, True),
             (64, 2048, 229, 6, 128, True), (64, 2048, 229, 4, 192, True), (64, 2048, 229, 3, 256, True))
# K5: (B, Sq, Sk, heads, head width, mha_bshd's transposed views with a mask).
K5_SHAPES = ((16, 577, 577, 16, 64, False), (64, 2048, 229, 8, 96, True))
# K4: (B, Sq, Sk, heads of a 768-wide model, masked): the vqa_med_full train
# shapes (BERT, BTIA both ways, img <- txt at D 128 / 192 / 256), then the
# serve step's under disable_fused().
K4_SHAPES = ((64, 32, 32, 12, True), (64, 197, 32, 12, True), (64, 32, 197, 12, False),
             (64, 197, 32, 6, True), (64, 197, 32, 4, True), (64, 197, 32, 3, True),
             (2048, 32, 32, 12, True), (2048, 50, 32, 12, True), (2048, 32, 50, 12, False),
             (2048, 64, 82, 12, True))
# K6: (B, H, Ni, Nt, D, bicross_bshd's transposed views): pooled, long tile.
K6_SHAPES = ((2048, 12, 50, 32, 64, False), (16, 12, 577, 64, 64, True))
# K1/K2's attention core: (B, Sq, Sk, heads of a 768-wide model, key mask,
# K2's shared query table): the serve sites (BERT, BTIA both ways, K2), the
# train sites, and img <- txt at D 128 / 192 / 256.
CORE_SHAPES = ((2048, 32, 32, 12, True, False), (2048, 50, 32, 12, True, False), (2048, 32, 50, 12, False, False),
               (2048, 64, 82, 12, True, True), (64, 32, 32, 12, True, False), (64, 197, 32, 12, True, False),
               (64, 32, 197, 12, False, False), (64, 197, 32, 6, True, False), (64, 197, 32, 4, True, False),
               (64, 197, 32, 3, True, False))
# The projection GEMM: (name, M, K, N, rows its residual repeats over).
GEMM_SHAPES = (("text_q", 65536, 768, 768, 0), ("text_kv", 65536, 768, 1536, 0),
               ("text_out", 65536, 768, 768, 65536), ("image_q", 102400, 768, 768, 0),
               ("image_kv", 102400, 768, 1536, 0), ("image_out", 102400, 768, 768, 102400),
               ("head_kv", 167936, 768, 1536, 0), ("head_out", 131072, 768, 768, 64))


def load_native(root: Path, name: str):
    """A checkout's ``ops/_native.py``, imported by path under `name`."""
    spec = importlib.util.spec_from_file_location(name, root / "btia_tpu_torch" / "ops" / "_native.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if len(sys.argv) != 2 or not (Path(sys.argv[1]) / "btia_tpu_torch" / "csrc").is_dir():
        print(f"usage: {sys.argv[0]} <checkout holding btia_tpu_torch/csrc>", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = {"parent": load_native(Path(sys.argv[1]).resolve(), "parent_native").lib(),
            "this": load_native(REPO, "this_native").lib()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def turns(name, make):
        """make(lib) -> (launch, output or a tuple of outputs); times in the
        order parent, this, this, parent."""
        times, outs = {"parent": [], "this": []}, {}
        for who in ("parent", "this", "this", "parent"):
            launch, out = make(libs[who])
            code = launch()
            torch.cuda.synchronize()
            if code != 0:
                raise RuntimeError(f"{name}: the {who} kernel returned CUDA error {code}")
            outs[who] = torch.cat([o.float().flatten() for o in (out if isinstance(out, tuple) else (out,))])
            times[who].append(time_ms(launch))
        diff = (outs["parent"] - outs["this"]).abs().max().item()
        print(f"{name}: parent {[round(t, 4) for t in times['parent']]} ms, this tree "
              f"{[round(t, 4) for t in times['this']]} ms, max |parent - this| {diff:.3g}", flush=True)

    def strides(*ts):
        return (ctypes.c_longlong * 12)(*(x.stride(i) for x in ts for i in range(3)))

    for B, Sq, Sk, H, D, masked in K3_SHAPES:
        q, k, v = (torch.randn(B, S, H * D, generator=g, device=dev).to(bf) for S in (Sq, Sk, Sk))
        m = (torch.rand(B, Sk, generator=g, device=dev) > 0.2).float() if masked else None
        mp = None if m is None else m.data_ptr()

        def k3(lib, q=q, k=k, v=v, mp=mp, B=B, Sq=Sq, Sk=Sk, H=H, D=D):
            o = torch.empty_like(q)
            return (lambda: lib.btia_flash_bshd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mp, o.data_ptr(),
                                                B, H, D, Sq, Sk, 0.18, stream)), o

        turns(f"K3 {B} x {Sq} <- {Sk}, {H} heads of {D}", k3)
        view = lambda x, S: x.view(B, S, H, D).transpose(1, 2)
        o4 = torch.empty_like(q)
        st = strides(view(q, Sq), view(k, Sk), view(v, Sk), view(o4, Sq))
        four_d = lambda: libs["this"].btia_mha_bhsd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mp, o4.data_ptr(),
                                                    st, B, H, Sq, Sk, D, 0.18, stream)
        if four_d() != 0:
            raise RuntimeError("K3 shape through K5's entry: CUDA error")
        print(f"  the same bytes through K5's 4-D path, this tree: "
              f"{[round(time_ms(four_d), 4) for _ in range(2)]} ms", flush=True)
        del q, k, v, o4

    for B, Sq, Sk, H, D, views in K5_SHAPES:
        if views:
            q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev).to(bf).transpose(1, 2) for S in (Sq, Sk, Sk))
        else:
            q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev).to(bf) for S in (Sq, Sk, Sk))
        m = (torch.rand(B, Sk, generator=g, device=dev) > 0.2).float() if views else None

        def k5(lib, q=q, k=k, v=v, m=m, B=B, Sq=Sq, Sk=Sk, H=H, D=D):
            o = torch.empty_like(q)
            st = strides(q, k, v, o)
            return (lambda: lib.btia_mha_bhsd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              None if m is None else m.data_ptr(), o.data_ptr(), st, B, H, Sq, Sk,
                                              D, 0.18, stream)), o

        turns(f"K5 {B} x {H} heads x {Sq} <- {Sk}, D {D}{', transposed views' if views else ''}", k5)
        del q, k, v

    sys.path.insert(0, str(REPO))
    from btia_tpu_torch.ops.attention import fanout_strides, short_plan

    earlier = lambda lib, name, n: len(getattr(lib, name).argtypes) == n  # the earlier C signature
    for B, Sq, Sk, H, masked in K4_SHAPES:
        D = 768 // H
        q, k, v = (torch.randn(B, S, 768, generator=g, device=dev).to(bf) for S in (Sq, Sk, Sk))
        cm = (torch.rand(B, Sk, generator=g, device=dev) > 0.2).float() if masked else torch.ones(B, Sk, device=dev)
        plan = short_plan([(B, H, Sq, Sk)], D)

        def k4(lib, q=q, k=k, v=v, cm=cm, B=B, Sq=Sq, Sk=Sk, H=H, D=D, plan=plan):
            o = torch.empty_like(q)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cm.data_ptr(), o.data_ptr())
            if earlier(lib, "btia_fanout", 12):
                return (lambda: lib.btia_fanout(*ptrs, B, H, D, Sq, Sk, 0.18, stream)), o
            st = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in fanout_strides(t, H)))
            pl = (ctypes.c_int * len(plan))(*plan)
            return (lambda: lib.btia_fanout(*ptrs, st, pl, B, H, Sq, Sk, D, 0.18, stream)), o

        turns(f"K4 {B} x {Sq} <- {Sk}, {H} heads of {D}", k4)
        del q, k, v

    for B, H, Ni, Nt, D, views in K6_SHAPES:
        def operand(S):
            if views:
                return torch.randn(B, S, H, D, generator=g, device=dev).to(bf).transpose(1, 2)
            return torch.randn(B, H, S, D, generator=g, device=dev).to(bf)

        xs = [operand(S) for S in (Ni, Ni, Ni, Nt, Nt, Nt)]
        m = torch.rand(B, Nt, generator=g, device=dev) > 0.2
        mf = m.float()  # the earlier entry's f32 mask
        plan = short_plan([(B, H, Ni, Nt), (B, H, Nt, Ni)], D)

        def k6(lib, xs=xs, m=m, mf=mf, B=B, H=H, Ni=Ni, Nt=Nt, D=D, plan=plan):
            oi, ot = torch.empty_like(xs[0]), torch.empty_like(xs[3])
            st = (ctypes.c_longlong * 24)(*(x.stride(i) for x in (*xs, oi, ot) for i in range(3)))
            ptrs = [x.data_ptr() for x in xs]
            if earlier(lib, "btia_bicross", 17):
                return (lambda: lib.btia_bicross(*ptrs, mf.data_ptr(), oi.data_ptr(), ot.data_ptr(), st, B, H, Ni,
                                                 Nt, D, 0.18, stream)), (oi, ot)
            pl = (ctypes.c_int * len(plan))(*plan)
            return (lambda: lib.btia_bicross(*ptrs, m.data_ptr(), oi.data_ptr(), ot.data_ptr(), st, pl, B, H, Ni, Nt,
                                             D, 0.18, stream)), (oi, ot)

        turns(f"K6 {B} x {H} heads, {Ni} <-> {Nt}, D {D}{', transposed views' if views else ''}", k6)
        del xs

    from btia_tpu_torch.ops.fused_attn import core_operands

    for B, Sq, Sk, H, masked, shared in CORE_SHAPES:
        HD, D = 768, 768 // H
        q = (torch.randn(Sq if shared else B * Sq, HD, generator=g, device=dev) * D**-0.25).to(bf)
        kv = (torch.randn(B * Sk, 2 * HD, generator=g, device=dev) * D**-0.25).to(bf)
        m = torch.rand(B, Sk, generator=g, device=dev) > 0.2 if masked else None
        mf = None if m is None else m.float()  # the wmma core's f32 mask
        plan = short_plan([(B, H, Sq, Sk)], D)

        def core(lib, q=q, kv=kv, m=m, mf=mf, B=B, Sq=Sq, Sk=Sk, H=H, D=D, HD=HD, shared=shared, plan=plan):
            o = torch.empty(B * Sq, HD, dtype=bf, device=dev)
            v_ptr = kv.data_ptr() + 2 * HD
            if lib.btia_attn_core.argtypes[1] is ctypes.c_longlong:  # the wmma core's C signature
                return (lambda: lib.btia_attn_core(q.data_ptr(), 0 if shared else Sq * HD, HD, kv.data_ptr(), v_ptr,
                                                   Sk * 2 * HD, 2 * HD, None if mf is None else mf.data_ptr(),
                                                   o.data_ptr(), B, H, D, Sq, Sk, stream)), o
            ops = core_operands(Sq, Sk, HD, H)
            st = (ctypes.c_longlong * 12)(*(s for n in "qkvo" for s in ops[n][1]))
            pl = (ctypes.c_int * len(plan))(*plan)
            return (lambda: lib.btia_attn_core(q.data_ptr(), kv.data_ptr(), v_ptr, None if m is None else m.data_ptr(),
                                               1, o.data_ptr(), st, pl, B, H, Sq, Sk, D, int(shared), stream)), o

        turns(f"K1/K2 core {B} x {Sq} <- {Sk}, {H} heads of {D}{', one query table' if shared else ''}", core)
        del q, kv, m, mf

    for name, M, K, N, rr in GEMM_SHAPES:
        a = torch.randn(M, K, generator=g, device=dev).to(bf)
        w = (torch.randn(K, N, generator=g, device=dev) * K**-0.5).to(bf)
        b = torch.randn(N, generator=g, device=dev) * 0.02
        r = torch.randn(rr, N, generator=g, device=dev).to(bf) if rr else None

        def gemm(lib, a=a, w=w, b=b, r=r, M=M, K=K, N=N, rr=rr):
            o = torch.empty(M, N, dtype=bf, device=dev)
            return (lambda: lib.btia_gemm_bias(a.data_ptr(), w.data_ptr(), b.data_ptr(),
                                               None if r is None else r.data_ptr(), max(rr, 1), o.data_ptr(),
                                               M, N, K, stream)), o

        turns(f"GEMM {name} {M} x {K} -> {N}", gemm)
        del a, w, b, r
    return 0


if __name__ == "__main__":
    sys.exit(main())
