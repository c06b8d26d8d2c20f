#!/usr/bin/env python3
"""Time the port's K3, K4, K5, K6, K1/K2's attention core and projection
GEMM, the f32 attention and GEMM, the wide-head attention and K8 against
another checkout's on one card, in turns.

    git archive <commit> btia_tpu_torch | tar -x -C runs/parent
    python3 compare_kernels.py runs/parent [groups]

groups: a comma-separated subset of k3, k5, k4, k6, core, gemm, mlp, f32,
wide, gemm_f32, k8, f32_wrap, k7, k7_bwd and mla (default: all).

Builds both checkouts' kernel libraries (each from its own
``btia_tpu_torch/csrc``), then runs each kernel's C entry at the shapes of
``chip_smoke.py``'s phases 2 and 2b in the order parent, this tree, this
tree, parent, and prints both pairs of times (CUDA events, ms a call) with
the largest difference between the two outputs. K3 and K5 (at phase 2's and
2b's shapes, ViT-L 16 x 577 through each entry) and the projection GEMM
(at every site of ``GEMM_SITES`` and ``GEMM_TRAIN_SITES``, with the per-step
sums weighted by launches; the ``mlp`` group: the same GEMM with ``Dense``'s
epilogue at the serve step's Mlp products, ``compare_mlp``) also time one
PyTorch call of the same function
in the same turns (parent, this, library, library, this, parent): SDPA,
and ``torch.addmm`` with the residual added; each line gives the bound
(``chip_smoke.bound_ms``) and each time's share of it. K3's shapes are also
timed through K5's entry with K3's packed strides: the 4-D (B, H, S, D)
tensor-map path over the same bytes. K4 runs at the six training shapes and the four
serve shapes of ``chip_smoke.py``'s phase 2, K6 at phase 2b's two, K1/K2's
attention core (``btia_attn_core``) at the four serve site shapes (K2's with
one shared query table) and the train site shapes (BTIA img <- txt also at
D 128, 192 and 256); where the other checkout's K4 / K6 / core entry has an
earlier C signature (no strides or plan; the core's: the wmma kernel's
row strides and an f32 key mask, given the same mask as 0 / 1), it is
called that way. The f32 attention (``btia_attn_simt``) runs at
``chip_smoke.py``'s phase 2c f32 shapes through each entry's operand layout
(K1/K2's core on the GEMM outputs, K3/K4 packed, K5 on transposed views,
K6's two directions), the wide-head attention (``btia_attn_wide``) at its
bf16 shapes in turns with SDPA on the same operands (parent, this,
library, library, this, parent), with the bound: this tree's cluster entry
and the other checkout's on the argument array ``attend_args`` packs; each
checkout's ``btia_attn_simt`` takes the f32 cases in its own argument
format (the same int64 array, or in an earlier checkout pointer, stride
and dims arrays); and the f32 GEMM
(``btia_gemm_f32``) at phase 2c's six sites, each entry called with its
own checkout's C signature. K8 (``k8``) runs at ``chip_smoke.py``'s
eight ``INT8_SITES`` and ``INT8_WIDE_K``: each checkout's row quantization
and int8 GEMM entries (``btia_int8_quant_rows`` + ``btia_int8_gemm``, each
with its own C signature) on the same bf16 x and (N, K) int8 weight, its
GEMM alone on the quantized rows, and this tree's model road (fc1: the
quantization and the GEMM that also takes the output's row amax; fc2: the
GEMM alone on bf16 x, which it quantizes; its output must equal the
entries'), in turns with two yardsticks timed only (parent, this,
``_int_mm``, bf16 ``addmm``, ``addmm``, ``_int_mm``, this, parent):
``torch._int_mm`` on the pre-quantized operands (the int8 product alone)
and bf16 ``torch.addmm`` of the same product with its bias (the path int8
replaces); each line gives the bound and each time's share of it, and the
last the 90 launches' sums weighted by ``launches_per_step``. The
``f32_wrap`` group times the f32 attention's wrappers (an entry's CUDA
half, host code included) at phase 2c's f32 cases, each checkout's in a
process of its own that imports that checkout's package, in turns
(parent, this, this, parent). K7 (``k7``) runs each checkout's
``btia_layernorm`` at the shapes of the serve step's standalone LayerNorms
(``SERVE_LN_CENSUS``), at ViT-L's rows in f32, at the train shapes of
``K7_BWD_SHAPES`` and at 6144, in turns with ``F.layer_norm`` (parent,
this, library, library, this, parent), with the bound and the serve step's
74 launches summed by the census. K7's backward (``k7_bwd``) runs this
tree's ``btia_layernorm_bwd`` at ``K7_BWD_SHAPES`` in bf16 and f32 against
the parent's backward, which has no kernel: the vjp of ``_ln_exact``
(``_ln_exact_vjp``, eager PyTorch), with
``torch.ops.aten.native_layer_norm_backward`` as the library call, in the
same turns. The MLA attention core (``mla``) runs at one layer of
``kimivl-fanout-backlog`` (``chip_smoke.MLA_SHAPE``): each checkout's
``btia_mla_attn`` C entry in turns (parent, this, this, parent), or, where
the other checkout has none, its road, the grid code (this tree's twin,
``ops/mla.py::_mla_plain``, is that code), in the parent's turns; then this
tree's wrapper; with the bytes bound. Inputs are
random from a seed; the card's name and power limit are printed first.
Needs one CUDA card and ``nvcc``.
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
def load_native(root: Path, name: str):
    """A checkout's ``ops/_native.py``, imported by path under `name`."""
    spec = importlib.util.spec_from_file_location(name, root / "btia_tpu_torch" / "ops" / "_native.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GROUPS = ("k3", "k5", "k4", "k6", "core", "gemm", "mlp", "f32", "wide", "gemm_f32", "k8", "f32_wrap", "k7",
          "k7_bwd", "mla")


def wrapper_times(root: Path) -> int:
    """In a process of its own: each f32 attention case of ``chip_smoke.py``
    phase 2c through its entry's CUDA half (the wrapper: host code and
    kernel), ms a call on CUDA events, with `root`'s ``btia_tpu_torch``
    imported (this file's ``chip_smoke`` for the cases). Prints one JSON
    object, case -> ms."""
    sys.path[:0] = [str(root), str(REPO)]
    import json

    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for name, entry, dims in cs.SIMT_F32_CASES:
        kernel = cs._simt_case(torch, dev, name, entry, dims, torch.float32, g)[0]
        out[name] = cs.cuda_time_ms(kernel, 20)
    print(json.dumps(out), flush=True)
    return 0


def compare_wrappers(torch, parent: Path) -> None:
    """The f32 attention's wrappers (host code included), the other
    checkout's and this tree's, each in a process of its own, in turns
    (parent, this, this, parent)."""
    import json

    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        root = parent if who == "parent" else REPO
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--wrappers", str(root)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"the {who} wrappers failed:\n{res.stderr[-3000:]}")
        times[who].append(json.loads(res.stdout.strip().splitlines()[-1]))
    for name in times["this"][0]:
        p, t = ([round(x[name], 4) for x in times[w]] for w in ("parent", "this"))
        print(f"f32 wrapper {name}: parent {p} ms, this tree {t} ms", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--wrappers":
        return wrapper_times(Path(sys.argv[2]).resolve())
    groups = set(sys.argv[2].split(",")) if len(sys.argv) == 3 else set(GROUPS)
    if len(sys.argv) not in (2, 3) or not (Path(sys.argv[1]) / "btia_tpu_torch" / "csrc").is_dir() \
            or not groups <= set(GROUPS):
        print(f"usage: {sys.argv[0]} <checkout holding btia_tpu_torch/csrc> [{','.join(GROUPS)}]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from btia_tpu_torch.ops.attention import flash_plan
    from btia_tpu_torch.ops.gemm import GEMM_TILES, gemm_plan

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

    def turns(name, make, library=None, bound=None):
        """make(lib) -> (launch, output or a tuple of outputs); times in the
        order parent, this, this, parent, or with a library yardstick (one
        PyTorch call of the same function, timed only) parent, this,
        library, library, this, parent. bound: (flops, bytes), printed as
        the least time the card could take and each time's share of it.
        Returns {"parent": [ms, ms], "this": [...], "library": [...]}."""
        times, outs = {"parent": [], "this": [], "library": []}, {}
        order = ("parent", "this", "this", "parent") if library is None else \
            ("parent", "this", "library", "library", "this", "parent")
        for who in order:
            if who == "library":
                times[who].append(time_ms(library))
                continue
            launch, out = make(libs[who])
            code = launch()
            torch.cuda.synchronize()
            if code != 0:
                raise RuntimeError(f"{name}: the {who} kernel returned CUDA error {code}")
            outs[who] = torch.cat([o.float().flatten() for o in (out if isinstance(out, tuple) else (out,))])
            times[who].append(time_ms(launch))
        diff = (outs["parent"] - outs["this"]).abs().max().item()
        line = (f"{name}: parent {[round(t, 4) for t in times['parent']]} ms, this tree "
                f"{[round(t, 4) for t in times['this']]} ms")
        if library is not None:
            line += f", library {[round(t, 4) for t in times['library']]} ms"
        if bound is not None:
            b_ms, by = cs.bound_ms(*bound)
            share = lambda who: round(b_ms / min(times[who]), 3)
            line += (f", bound {b_ms:.4f} ms ({by}; share parent {share('parent')}, this {share('this')}"
                     + (f", library {share('library')}" if library is not None else "") + ")")
        print(f"{line}, max |parent - this| {diff:.3g}", flush=True)
        return times

    def strides(*ts):
        return (ctypes.c_longlong * 12)(*(x.stride(i) for x in ts for i in range(3)))

    import torch.nn.functional as F

    sdpa = F.scaled_dot_product_attention
    # The earlier C signatures of K3's and K5's entries: an f32 mask, no grid.
    flash_old = lambda lib: len(lib.btia_flash_bshd.argtypes) == 12
    for B, Sq, Sk, H, D, masked in K3_SHAPES if "k3" in groups else ():
        q, k, v = (torch.randn(B, S, H * D, generator=g, device=dev).to(bf) for S in (Sq, Sk, Sk))
        mb = torch.rand(B, Sk, generator=g, device=dev) > 0.2 if masked else None
        mf = None if mb is None else mb.float()
        items, grid = flash_plan(B, H, Sq, D)

        def k3(lib, q=q, k=k, v=v, mb=mb, mf=mf, B=B, Sq=Sq, Sk=Sk, H=H, D=D, grid=grid):
            o = torch.empty_like(q)
            qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            if flash_old(lib):
                return (lambda: lib.btia_flash_bshd(*qkv, None if mf is None else mf.data_ptr(), o.data_ptr(),
                                                    B, H, D, Sq, Sk, 0.18, stream)), o
            return (lambda: lib.btia_flash_bshd(*qkv, None if mb is None else mb.data_ptr(), o.data_ptr(),
                                                B, H, D, Sq, Sk, 0.18, grid, stream)), o

        split = lambda x, S, H=H, D=D, B=B: x.view(B, S, H, D).transpose(1, 2)
        keep = None if mb is None else mb[:, None, None, :]
        lib_fn = lambda q=q, k=k, v=v, keep=keep, Sq=Sq, Sk=Sk: sdpa(split(q, Sq), split(k, Sk), split(v, Sk),
                                                                     attn_mask=keep)
        flops, nbytes = 4 * B * H * Sq * Sk * D, 2 * (2 * q.numel() + k.numel() + v.numel()) + B * Sk * masked
        turns(f"K3 {B} x {Sq} <- {Sk}, {H} heads of {D} ({items} items, grid {grid})", k3, lib_fn, (flops, nbytes))
        view = lambda x, S: x.view(B, S, H, D).transpose(1, 2)
        o4 = torch.empty_like(q)
        st = strides(view(q, Sq), view(k, Sk), view(v, Sk), view(o4, Sq))
        four_d = lambda: libs["this"].btia_mha_bhsd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                    None if mb is None else mb.data_ptr(), o4.data_ptr(), st, B, H,
                                                    Sq, Sk, D, 0.18, grid, stream)
        if four_d() != 0:
            raise RuntimeError("K3 shape through K5's entry: CUDA error")
        print(f"  the same bytes through K5's 4-D path, this tree: "
              f"{[round(time_ms(four_d), 4) for _ in range(2)]} ms", flush=True)
        del q, k, v, o4

    for B, Sq, Sk, H, D, views in K5_SHAPES if "k5" in groups else ():
        if views:
            q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev).to(bf).transpose(1, 2) for S in (Sq, Sk, Sk))
        else:
            q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev).to(bf) for S in (Sq, Sk, Sk))
        mb = torch.rand(B, Sk, generator=g, device=dev) > 0.2 if views else None
        mf = None if mb is None else mb.float()
        # K5's entry takes heads of 8k columns: D 96 as it is (DP 128).
        items, grid = flash_plan(B, H, Sq, D)

        def k5(lib, q=q, k=k, v=v, mb=mb, mf=mf, B=B, Sq=Sq, Sk=Sk, H=H, D=D, grid=grid):
            o = torch.empty_like(q)
            st = strides(q, k, v, o)
            qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            if len(lib.btia_mha_bhsd.argtypes) == 13:  # the earlier C signature
                return (lambda: lib.btia_mha_bhsd(*qkv, None if mf is None else mf.data_ptr(), o.data_ptr(), st, B,
                                                  H, Sq, Sk, D, 0.18, stream)), o
            return (lambda: lib.btia_mha_bhsd(*qkv, None if mb is None else mb.data_ptr(), o.data_ptr(), st, B, H,
                                              Sq, Sk, D, 0.18, grid, stream)), o

        keep = None if mb is None else mb[:, None, None, :]
        lib_fn = lambda q=q, k=k, v=v, keep=keep: sdpa(q, k, v, attn_mask=keep)
        flops, nbytes = 4 * B * H * Sq * Sk * D, 2 * (2 * q.numel() + k.numel() + v.numel()) + B * Sk * views
        turns(f"K5 {B} x {H} heads x {Sq} <- {Sk}, D {D}{', transposed views' if views else ''} "
              f"({items} items, grid {grid})", k5, lib_fn, (flops, nbytes))
        del q, k, v

    from btia_tpu_torch.ops.attention import fanout_strides, short_plan

    earlier = lambda lib, name, n: len(getattr(lib, name).argtypes) == n  # the earlier C signature
    for B, Sq, Sk, H, masked in K4_SHAPES if "k4" in groups else ():
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

    for B, H, Ni, Nt, D, views in K6_SHAPES if "k6" in groups else ():
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

    for B, Sq, Sk, H, masked, shared in CORE_SHAPES if "core" in groups else ():
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

    compare_f32_and_wide(torch, libs, turns, dev, g, stream, groups)
    if "f32_wrap" in groups:
        compare_wrappers(torch, Path(sys.argv[1]).resolve())
    if "k8" in groups:
        compare_k8(torch, libs, time_ms, dev, g, stream)
    if "mlp" in groups:
        compare_mlp(torch, libs, time_ms, dev, g, stream)
    if "k7" in groups:
        compare_k7(torch, libs, turns, dev, g, stream)
    if "k7_bwd" in groups:
        compare_k7_bwd(torch, libs, time_ms, dev, g, stream)
    if "mla" in groups:
        compare_mla(torch, libs, time_ms, dev)

    per_step = {}
    for name, M, K, N, rr, launches in (cs.GEMM_SITES + cs.GEMM_TRAIN_SITES) if "gemm" in groups else ():
        a = torch.randn(M, K, generator=g, device=dev).to(bf)
        w = (torch.randn(K, N, generator=g, device=dev) * K**-0.5).to(bf)
        b = torch.randn(N, generator=g, device=dev) * 0.02
        r = torch.randn(rr, N, generator=g, device=dev).to(bf) if rr else None
        tile, grid = gemm_plan(M, N)

        def gemm(lib, a=a, w=w, b=b, r=r, M=M, K=K, N=N, rr=rr, tile=tile, grid=grid):
            o = torch.empty(M, N, dtype=bf, device=dev)
            args = (a.data_ptr(), w.data_ptr(), b.data_ptr(), None if r is None else r.data_ptr(), max(rr, 1),
                    o.data_ptr(), M, N, K)
            if len(lib.btia_gemm_bias.argtypes) == 10:  # the earlier C signature: one 128 x 128 tile a block
                return (lambda: lib.btia_gemm_bias(*args, stream)), o
            if len(lib.btia_gemm_bias.argtypes) == 12:  # the earlier C signature: no activation
                return (lambda: lib.btia_gemm_bias(*args, tile, grid, stream)), o
            return (lambda: lib.btia_gemm_bias(*args, 0, tile, grid, stream)), o

        b_bf = b.to(bf)

        def addmm(a=a, w=w, b_bf=b_bf, r=r, rr=rr, N=N):
            y = torch.addmm(b_bf, a, w)
            if r is not None:  # the residual, repeating every rr rows
                y.view(-1, rr, N).add_(r)
            return y

        nbytes = 2 * (a.numel() + w.numel() + M * N + (r.numel() if rr else 0)) + 4 * N
        times = turns(f"GEMM {name} {M} x {K} -> {N}{f', residual every {rr} rows' if rr else ''} "
                      f"(tile {GEMM_TILES[tile]}, grid {grid})", gemm, addmm, (2 * M * K * N, nbytes))
        path = "serve_step" if any(name == x[0] for x in cs.GEMM_SITES) else "train_step"
        acc = per_step.setdefault(path, {"launches": 0, "parent": 0.0, "this": 0.0, "library": 0.0})
        acc["launches"] += launches
        for who in ("parent", "this", "library"):
            acc[who] += launches * min(times[who])
        del a, w, b, r
    for path, acc in per_step.items():
        print(f"GEMM per {path.replace('_', ' ')} ({acc['launches']} launches, the better turn of each site): "
              f"parent {acc['parent']:.3f} ms, this tree {acc['this']:.3f} ms, addmm {acc['library']:.3f} ms",
              flush=True)
    return 0


def attention_problems(torch, entry, dims, dt, dev, g):
    """One attention call of phase 2c as the entry lays it out: (inputs, a
    function that makes fresh outputs and returns (problems, outputs), D,
    mult_mask, SDPA on the same operands, (flops, bytes) for the bound).
    Problems are (q, k, v, o, mask, qscale) of (B, H, S, D) views;
    ``ops/attention.py::operand`` makes them the specs the launchers take."""
    import torch.nn.functional as F

    from btia_tpu_torch.ops.attention import _log2_scale
    from btia_tpu_torch.ops.fused_attn import core_operands

    B, Sq, Sk, H, D = (dims[k] for k in ("B", "Sq", "Sk", "H", "D"))
    HD, c = H * D, _log2_scale(D)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(dt)
    mask = torch.rand(B, Sk, generator=g, device=dev) > 0.2 if dims.get("masked") else None
    sdpa_mask = None if mask is None else mask[:, None, None, :]
    heads = lambda x: x.unflatten(2, (H, D)).transpose(1, 2)
    sdpa = F.scaled_dot_product_attention
    el = torch.empty((), dtype=dt).element_size()
    flops = 4 * B * H * Sq * Sk * D
    io = lambda *ts: sum(t.numel() * t.element_size() for t in ts if t is not None)
    if entry == "core":
        shared = dims.get("shared", False)
        q, kv = (r(Sq if shared else B * Sq, HD) * c), r(B * Sk, 2 * HD)
        ops = core_operands(Sq, Sk, HD, H)
        if shared:
            ops["q"] = (0, [0, *ops["q"][1][1:]])
        view = lambda t, n, S: t.as_strided((B, H, S, D), (*ops[n][1], 1), t.storage_offset() + ops[n][0])

        def make():
            o = torch.empty(B * Sq, HD, dtype=dt, device=dev)
            return [(view(q, "q", Sq), view(kv, "k", Sk), view(kv, "v", Sk), view(o, "o", Sq), mask, 1.0)], (o,)
        qv = view(q, "q", Sq)
        library = lambda: sdpa(qv, view(kv, "k", Sk), view(kv, "v", Sk), sdpa_mask)
        return (q, kv, mask), make, D, True, library, (flops, io(q, kv, mask) + B * Sq * HD * el)
    if entry in ("k3", "k4"):
        q, k, v = r(B, Sq, HD), r(B, Sk, HD), r(B, Sk, HD)
        m = mask if entry == "k3" or mask is None else mask.float()

        def make():
            o = torch.empty_like(q)
            return [(heads(q), heads(k), heads(v), heads(o), m, c)], (o,)
        library = lambda: sdpa(heads(q), heads(k), heads(v), sdpa_mask)
        return (q, k, v, m), make, D, entry == "k4", library, (flops, io(q, k, v, mask, q))
    if entry == "k5":
        q, k, v = (r(B, S, H, D).transpose(1, 2) for S in (Sq, Sk, Sk))

        def make():
            o = torch.empty_like(q)
            return [(q, k, v, o, mask, c)], (o,)
        return (q, k, v, mask), make, D, False, lambda: sdpa(q, k, v, sdpa_mask), (flops, io(q, k, v, mask, q))
    xs = [r(B, H, S, D) for S in (Sq, Sq, Sq, Sk, Sk, Sk)]  # k6: qi, ki, vi, qt, kt, vt

    def make():
        oi, ot = torch.empty_like(xs[0]), torch.empty_like(xs[3])
        return [(xs[0], xs[4], xs[5], oi, mask, c), (xs[3], xs[1], xs[2], ot, None, c)], (oi, ot)
    library = lambda: (sdpa(xs[0], xs[4], xs[5], sdpa_mask), sdpa(xs[3], xs[1], xs[2]))
    return (xs, mask), make, D, False, library, (2 * flops, io(*xs, mask, xs[0], xs[3]))


def _problem_arrays(packed):
    """An earlier checkout's ``btia_attn_simt`` arguments, from what
    ``attend_args`` packed: the pointer, stride, dims and scale arrays, the
    masks' element size, and the tensors that must outlive the call."""
    from btia_tpu_torch.ops.attention import ATTEND_ARGS

    args, scales, mask_bytes, keep, _ = packed
    rows = [args[i:i + ATTEND_ARGS] for i in range(0, len(args), ATTEND_ARGS)]
    n = len(rows)
    return ((ctypes.c_void_p * (5 * n))(*(x for r in rows for x in r[:5])),
            (ctypes.c_longlong * (12 * n))(*(x for r in rows for x in r[5:17])),
            (ctypes.c_int * (4 * n))(*(x for r in rows for x in r[17:21])),
            (ctypes.c_float * n)(*scales[:n]), mask_bytes, keep)


def compare_f32_and_wide(torch, libs, turns, dev, g, stream, groups):
    """The f32 attention, the wide-head attention and the f32 GEMM, this
    tree against the other checkout, each through its own C signature; the
    wide-head attention also beside SDPA, with the bound."""
    import chip_smoke as cs
    from btia_tpu_torch.ops.attention import attend_args, operand, simt_plan, wide_plan
    from btia_tpu_torch.ops.gemm import GEMM_F32_TILES, gemm_f32_tile

    cases = [(n, e, d, torch.float32) for n, e, d in cs.SIMT_F32_CASES] if "f32" in groups else []
    cases += [(n, e, d, torch.bfloat16) for n, e, d in cs.wide_cases() if d["D"] % 8 == 0] if "wide" in groups else []
    for name, entry, dims, dt in cases:
        keep, make, D, mult, library, bound = attention_problems(torch, entry, dims, dt, dev, g)

        def attn(lib, make=make, D=D, mult=mult, dt=dt, keep=keep):
            problems, outs = make()
            problems = [(*map(operand, p[:4]), *p[4:]) for p in problems]
            n = len(problems)
            simt = lib.btia_attn_simt
            if dt == torch.float32:
                plan = (ctypes.c_int * 3)(*simt_plan(problems, D))
                packed = attend_args(problems)
                if simt.argtypes[0] is not ctypes.POINTER(ctypes.c_longlong):  # pointer, stride and dims arrays
                    arrays = _problem_arrays(packed)
                    return (lambda: simt(*arrays[:4], n, D, arrays[4], int(mult), plan, stream)), outs
                args, (qs0, qs1), mask_bytes, kept, _ = packed
                return (lambda kept=kept: simt(args, n, qs0, qs1, D, mask_bytes, int(mult), plan, stream)), outs
            args, (qs0, qs1), mask_bytes, kept, _ = attend_args(problems, D)
            sw, ns = wide_plan(D)
            return (lambda kept=kept: lib.btia_attn_wide(args, n, qs0, qs1, D, sw, ns, mask_bytes, int(mult),
                                                         stream)), outs

        b_, sq, sk, h = (dims[k] for k in ("B", "Sq", "Sk", "H"))
        what = f"{'f32' if dt == torch.float32 else 'wide bf16'} {name}: {b_} x {h} heads of {D}, {sq} <- {sk}"
        if dt == torch.float32:
            turns(what, attn)
        else:
            sw, ns = wide_plan(D)
            turns(f"{what}, clusters of {ns} x {sw} columns", attn, library, bound)
        del keep, make
        torch.cuda.empty_cache()

    for name, M, K, N, rr in cs.GEMM_F32_SITES if "gemm_f32" in groups else ():
        a = torch.randn(M, K, generator=g, device=dev)
        w = torch.randn(K, N, generator=g, device=dev) / K**0.5
        b = torch.randn(N, generator=g, device=dev)
        res = torch.randn(rr, N, generator=g, device=dev) if rr else None

        def gemm(lib, a=a, w=w, b=b, res=res, M=M, K=K, N=N, rr=rr):
            o = torch.empty(M, N, device=dev)
            args = (a.data_ptr(), w.data_ptr(), b.data_ptr(), None if res is None else res.data_ptr(), max(rr, 1),
                    o.data_ptr(), M, N, K)
            if len(lib.btia_gemm_f32.argtypes) == 10:  # the earlier signature: one 64 x 64 tile
                return (lambda: lib.btia_gemm_f32(*args, stream)), o
            return (lambda: lib.btia_gemm_f32(*args, gemm_f32_tile(M, N), 1, stream)), o

        turns(f"f32 GEMM {name} {M} x {K} -> {N} (block tile {GEMM_F32_TILES[gemm_f32_tile(M, N)]})", gemm)
        del a, w, b, res


def _ln_inputs(torch, M, D, dt, dev, g):
    x = (torch.randn(M, D, generator=g, device=dev) * 2 + 0.5).to(dt)
    return x, 1 + 0.2 * torch.randn(D, generator=g, device=dev), 0.1 * torch.randn(D, generator=g, device=dev)


def compare_k7(torch, libs, turns, dev, g, stream):
    """K7's forward C entry, each checkout's, in turns with F.layer_norm (on
    scale and bias in x's type): the serve step's LayerNorm shapes, ViT-L's
    rows in f32, the train shapes and 6144; the serve step's sums weighted
    by its census."""
    import torch.nn.functional as F

    import chip_smoke as cs

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(f"serve {M} x {D}", M, D, bf, n) for (M, D), n in sorted(cs.SERVE_LN_CENSUS.items())]
    cases += [("ViT-L f32", cs.B_IMG * 577, 1024, f32, 0)]
    cases += [(f"train {n} {M} x {D}", M, D, bf, 0) for n, M, D in cs.K7_BWD_SHAPES] + [("wide 2048 x 6144", 2048, 6144, bf, 0)]
    total = {"parent": 0.0, "this": 0.0, "library": 0.0, "bound": 0.0}
    for name, M, D, dt, per_step in cases:
        x, sc, bi = _ln_inputs(torch, M, D, dt, dev, g)
        w, b = sc.to(dt), bi.to(dt)

        def k7(lib, x=x, sc=sc, bi=bi, M=M, D=D, dt=dt):
            y = torch.empty_like(x)
            return (lambda: lib.btia_layernorm(x.data_ptr(), y.data_ptr(), sc.data_ptr(), bi.data_ptr(), M, D, 1e-6,
                                               int(dt == f32), stream)), y

        bound = (8 * x.numel(), 2 * x.numel() * x.element_size() + 8 * D)
        times = turns(f"K7 {name} {str(dt).removeprefix('torch.')}", k7,
                      lambda x=x, w=w, b=b, D=D: F.layer_norm(x, (D,), w, b, 1e-6), bound)
        for who in ("parent", "this", "library"):
            total[who] += per_step * min(times[who])
        total["bound"] += per_step * cs.bound_ms(*bound)[0]
        del x
    print(f"K7 per serve step ({sum(cs.SERVE_LN_CENSUS.values())} launches, the better turn of each shape): "
          f"parent {total['parent']:.4f} ms, this tree {total['this']:.4f} ms, F.layer_norm {total['library']:.4f} ms, "
          f"bound {total['bound']:.4f} ms", flush=True)


def compare_k7_bwd(torch, libs, time_ms, dev, g, stream):
    """K7's backward at K7_BWD_SHAPES, bf16 and f32: this tree's C entry
    (dx, dscale, dbias through its partial rows), the parent's backward (the
    eager vjp of ``_ln_exact``: the parent has no backward kernel) and
    ``native_layer_norm_backward`` in turns (parent, this, library, library,
    this, parent), each line with the bound and this tree's largest
    difference from the parent's gradients."""
    import chip_smoke as cs
    from btia_tpu_torch.ops import norms as N

    for name, M, D in cs.K7_BWD_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x, sc, bi = _ln_inputs(torch, M, D, dt, dev, g)
            gr = torch.randn(M, D, generator=g, device=dev).to(dt)
            dx, ds, db = torch.empty_like(x), torch.empty(D, device=dev), torch.empty(D, device=dev)
            rows = libs["this"].btia_layernorm_bwd_parts(x.data_ptr(), gr.data_ptr(), sc.data_ptr(), dx.data_ptr(), M,
                                                         D, int(dt == torch.float32))
            part = torch.empty(rows, 2 * D, device=dev)
            this = lambda: libs["this"].btia_layernorm_bwd(
                x.data_ptr(), gr.data_ptr(), sc.data_ptr(), dx.data_ptr(), ds.data_ptr(), db.data_ptr(),
                part.data_ptr(), rows, M, D, 1e-6, int(dt == torch.float32), stream)
            parent = lambda: N._ln_exact_vjp(x, sc, bi, gr, 1e-6)
            w, b = sc.to(dt), bi.to(dt)
            _, mean, rstd = torch.ops.aten.native_layer_norm(x, (D,), w, b, 1e-6)
            library = lambda: torch.ops.aten.native_layer_norm_backward(gr, x, (D,), mean, rstd, w, b,
                                                                        [True, True, True])
            if this() != 0:
                raise RuntimeError(f"K7 backward {name}: CUDA error")
            ref = parent()
            torch.cuda.synchronize()
            diff = [(a.float() - r.float()).abs().max().item() for a, r in zip((dx, ds, db), ref)]
            times = {"parent": [], "this": [], "library": []}
            for who in ("parent", "this", "library", "library", "this", "parent"):
                times[who].append(time_ms({"parent": parent, "this": this, "library": library}[who],
                                          5 if who == "parent" else 20))
            b_ms, by = cs.bound_ms(20 * x.numel(), 3 * x.numel() * x.element_size() + 12 * D, cs.PEAK_F32_SIMT)
            fmt = lambda k: [round(t, 4) for t in times[k]]
            print(f"K7 backward {name} {M} x {D} {str(dt).removeprefix('torch.')}: parent (eager vjp) "
                  f"{fmt('parent')} ms, this tree {fmt('this')} ms, native_layer_norm_backward {fmt('library')} ms, "
                  f"bound {b_ms:.4f} ms ({by}; share this {b_ms / min(times['this']):.3f}, library "
                  f"{b_ms / min(times['library']):.3f}); max |this - parent| dx / dscale / dbias "
                  f"{' / '.join(f'{d:.3g}' for d in diff)}", flush=True)
            del x, gr, dx, part, ref


def compare_k8(torch, libs, time_ms, dev, g, stream):
    """K8 at the int8 serve step's eight FFN sites and at INT8_WIDE_K: the
    parent's entries (quantize + GEMM, and the GEMM alone), this tree's
    model road (at a GELU site the quantization and the GEMM that also
    takes the output's row amax; at the others the GEMM alone on bf16 x at
    its rows' amax) and its entries as the ops API runs them (quantize +
    GEMM), ``_int_mm`` and bf16 ``addmm`` in turns; the sums weighted by
    launches a step."""
    import chip_smoke as cs
    from btia_tpu_torch.ops import quant as Q
    from btia_tpu_torch.ops.gemm import ACTS

    bf = torch.bfloat16
    names = ("parent", "this", "parent_gemm", "this_gemm", "this_road", "int_mm", "addmm")
    total = {k: 0.0 for k in names + ("bound",)}
    launches = 0
    for name, M, K, N, act, per_step in cs.INT8_SITES + (cs.INT8_WIDE_K,):
        x = (torch.randn(M, K, generator=g, device=dev) * 2).to(bf)
        w = torch.randn(K, N, generator=g, device=dev) * K**-0.5
        b = torch.randn(N, generator=g, device=dev) * 0.02
        w_i8, ws = Q.quantize_weight(w)
        w_nk = w_i8.t().contiguous()
        xi, sx = Q._quantize_rows_plain(x)
        x_amax = Q._row_amax_plain(x)
        act_i = ACTS.index(act)
        _, grid = Q.int8_plan(M, N)

        def entry(lib, mode):
            """mode: "pair" (quantize + GEMM), "gemm" (the GEMM on xi) or
            "road" (this tree's model road)."""
            y = torch.empty(M, N, dtype=bf, device=dev)
            qi, qs = torch.empty(M, K, dtype=torch.int8, device=dev), torch.empty(M, dtype=torch.float32, device=dev)
            amax = torch.zeros(M, dtype=torch.float32, device=dev)
            earlier = len(lib.btia_int8_gemm.argtypes) == 12  # the parent's C signature

            def gemm(a, scale, a_bf16=0, row_amax=None):
                if earlier:
                    return lib.btia_int8_gemm(a.data_ptr(), scale.data_ptr(), w_nk.data_ptr(), ws.data_ptr(),
                                              b.data_ptr(), y.data_ptr(), M, N, K, act_i, 0, stream)
                return lib.btia_int8_gemm(a.data_ptr(), scale.data_ptr(), a_bf16, w_nk.data_ptr(), ws.data_ptr(),
                                          b.data_ptr(), y.data_ptr(), row_amax, M, N, K, act_i, 0, grid, stream)

            quant = lambda: lib.btia_int8_quant_rows(x.data_ptr(), qi.data_ptr(), qs.data_ptr(), M, K, stream)
            if mode == "gemm":
                return (lambda: gemm(xi, sx)), y
            if mode == "pair":
                return (lambda: quant() or gemm(qi, qs)), y
            if act is None:
                return (lambda: gemm(x, x_amax, 1)), y

            def road():
                amax.zero_()
                return quant() or gemm(qi, qs, 0, amax.data_ptr())

            return road, y

        w_col = w_nk.t()  # (K, N), column-major: _int_mm's layout for B
        w_bf, b_bf = w.to(bf), b.to(bf)
        yard = {"int_mm": lambda: torch._int_mm(xi, w_col), "addmm": lambda: torch.addmm(b_bf, x, w_bf)}
        times = {k: [] for k in names}
        outs = {}
        for who in ("parent", "this", "int_mm", "addmm", "addmm", "int_mm", "this", "parent"):
            if who in yard:
                times[who].append(time_ms(yard[who], 10))
                continue
            for mode in ("pair", "gemm") + (("road",) if who == "this" else ()):
                launch, out = entry(libs[who], mode)
                code = launch()
                torch.cuda.synchronize()
                if code != 0:
                    raise RuntimeError(f"K8 {name}: the {who} kernels ({mode}) returned CUDA error {code}")
                outs[f"{who}_{mode}"] = out.float()
                times[who + {"pair": "", "gemm": "_gemm", "road": "_road"}[mode]].append(time_ms(launch, 10))
        ref = Q._int8_mm_plain(x, w_i8, ws, b, act, bf).float()
        diff = {k: (v - ref).abs().max().item() for k, v in outs.items()}
        if not torch.equal(outs["this_road"], outs["this_pair"]):
            raise RuntimeError(f"K8 {name}: this tree's model road differs from its quantize + GEMM")
        b_ms, by = cs.bound_ms(2 * M * K * N, 2 * x.numel() + w_i8.numel() + 8 * N + 2 * M * N, cs.PEAK_INT8_OPS)
        best = {k: min(v) for k, v in times.items()}
        fmt = lambda k: [round(t, 4) for t in times[k]]
        print(f"K8 {name} {M} x {K} -> {N}{', GELU' if act else ''} (grid {grid}): quantize + GEMM parent "
              f"{fmt('parent')} ms, this tree {fmt('this')} ms; GEMM alone parent {fmt('parent_gemm')}, this tree "
              f"{fmt('this_gemm')}; this tree's model road {fmt('this_road')}; _int_mm {fmt('int_mm')}, bf16 addmm "
              f"{fmt('addmm')}; bound {b_ms:.4f} ms ({by}; share parent {b_ms / best['parent']:.3f}, this tree's "
              f"road {b_ms / best['this_road']:.3f}); max |y - twin| parent {diff['parent_pair']:.3g}, this "
              f"{diff['this_pair']:.3g}", flush=True)
        if per_step:
            for k in names:
                total[k] += per_step * best[k]
            total["bound"] += per_step * b_ms
            launches += per_step
        del x, w, b, w_i8, ws, w_nk, xi, sx, x_amax, w_col, w_bf, b_bf, outs
        torch.cuda.empty_cache()
    print(f"K8 per int8 serve step ({launches} launches, the better turn of each site): quantize + GEMM parent "
          f"{total['parent']:.3f} ms, this tree {total['this']:.3f} ms; GEMM alone parent {total['parent_gemm']:.3f}, "
          f"this tree {total['this_gemm']:.3f}; this tree's model road {total['this_road']:.3f}; _int_mm "
          f"{total['int_mm']:.3f}; bf16 addmm {total['addmm']:.3f}; bound {total['bound']:.3f}", flush=True)



def compare_mla(torch, libs, time_ms, dev):
    """The MLA attention core at ``chip_smoke.MLA_SHAPE`` (the module
    docstring): the C entries, or the parent's grid code, in turns, the
    largest difference between the two outputs, this tree's wrapper and the
    bound."""
    import chip_smoke as cs
    from btia_tpu_torch.ops import mla as A

    ops = cs.mla_inputs(torch, dev, 23)
    roads, outs = {}, {}
    for who in ("parent", "this"):
        if hasattr(libs[who], "btia_mla_attn"):
            launch, outs[who] = cs.mla_entry(torch, libs[who], *ops)
            if launch() != 0:
                raise RuntimeError(f"mla: the {who} kernel returned a CUDA error")
            roads[who] = launch
        else:  # the grid code the model ran before the kernel
            roads[who] = lambda: A._mla_plain(*ops)
            outs[who] = roads[who]()
    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        times[who].append(time_ms(roads[who], 10))
    wrapper = time_ms(lambda: A.mla_attention(*ops), 10)
    b_ms, by = cs.bound_ms(0.0, cs.mla_bytes(*ops[:5]))
    diff = (outs["parent"].float() - outs["this"].float()).abs().max().item()
    print(f"mla core {ops[0].shape[0]} tokens: parent {[round(t, 4) for t in times['parent']]} ms"
          f"{'' if hasattr(libs['parent'], 'btia_mla_attn') else ' (the grid code)'}, this tree "
          f"{[round(t, 4) for t in times['this']]} ms, wrapper {wrapper:.4f} ms, bound {b_ms:.4f} ms ({by}; share "
          f"this {round(b_ms / min(times['this']), 3)}), max |parent - this| {diff:.3g}", flush=True)


def compare_mlp(torch, libs, time_ms, dev, g, stream):
    """The projection GEMM with Dense's epilogue (the f32 bias, and at fc1
    the tanh-GELU) at the bf16 serve step's eight Mlp products
    (``chip_smoke.MLP_SITES``), this tree's C entry at gemm_plan's tile, in
    turns with the parent's C entry where it has the function (fc2: no
    activation; its output must equal this tree's bit for bit), with
    ``torch.addmm`` (the product and its bias in one library call: the
    yardstick), ``addmm`` then ``F.gelu`` at fc1, and the parent's chain as
    ``Dense`` ran it (the f32 weight and bias cast to bf16, ``matmul``, the
    broadcast bias add, ``F.gelu``): parent, this, addmm, addmm + GELU,
    chain, chain, addmm + GELU, addmm, this, parent. Then this tree's entry
    at each tile the shape admits (the plan's check). Each line gives the
    bound and each time's share of it, and this tree's time over addmm's;
    the last the 90 launches' sums weighted by ``launches_per_step``."""
    import torch.nn.functional as F

    import chip_smoke as cs
    from btia_tpu_torch.ops._native import H100_SMS
    from btia_tpu_torch.ops.gemm import GEMM_TILES, gemm_plan

    bf = torch.bfloat16
    names = ("parent", "this", "addmm", "addmm_gelu", "chain")
    total = {k: 0.0 for k in ("this", "addmm", "addmm_gelu", "chain", "bound")}
    launches = 0
    for name, M, K, N, act, per_step in cs.MLP_SITES:
        x = torch.randn(M, K, generator=g, device=dev).to(bf)
        w32 = torch.randn(K, N, generator=g, device=dev) * K**-0.5
        b = torch.randn(N, generator=g, device=dev) * 0.02
        w, b_bf = w32.to(bf), b.to(bf)
        tile, grid = gemm_plan(M, N)
        act_i = 1 if act else 0

        def entry(lib, tile=tile, grid=grid):
            y = torch.empty(M, N, dtype=bf, device=dev)
            args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), None, 1, y.data_ptr(), M, N, K)
            if len(lib.btia_gemm_bias.argtypes) == 12:  # the parent's C signature: no activation
                return (lambda: lib.btia_gemm_bias(*args, tile, grid, stream)), y
            return (lambda: lib.btia_gemm_bias(*args, act_i, tile, grid, stream)), y

        def chain():
            y = torch.matmul(x, w32.to(bf)) + b.to(bf)
            return F.gelu(y, approximate="tanh") if act else y

        yard = {"addmm": lambda: torch.addmm(b_bf, x, w), "chain": chain,
                "addmm_gelu": lambda: F.gelu(torch.addmm(b_bf, x, w), approximate="tanh")}
        order = ("parent", "this", "addmm", "addmm_gelu", "chain", "chain", "addmm_gelu", "addmm", "this", "parent")
        times = {k: [] for k in names}
        outs = {}
        for who in order:
            if who == "parent" and act:
                continue  # the parent's entry has no activation: its road is the chain
            if who == "addmm_gelu" and not act:
                continue
            if who in yard:
                times[who].append(time_ms(yard[who], 10))
                continue
            launch, out = entry(libs[who])
            code = launch()
            torch.cuda.synchronize()
            if code != 0:
                raise RuntimeError(f"Mlp {name}: the {who} GEMM returned CUDA error {code}")
            outs[who] = out
            times[who].append(time_ms(launch, 10))
        ref = x.float() @ w.float() + b
        ref = F.gelu(ref, approximate="tanh") if act else ref
        floor = 1e-6 * ref.abs().max()
        steps = ((outs["this"].float() - ref).abs() / (cs.bf16_steps(torch, ref) + floor)).max().item()
        same = "" if act else f", bits equal to the parent's: {torch.equal(outs['this'], outs['parent'])}"
        b_ms, by = cs.bound_ms(2 * M * K * N, 2 * (x.numel() + w.numel() + M * N) + 4 * N)
        best = {k: min(v) for k, v in times.items() if v}
        fmt = lambda k: [round(t, 4) for t in times[k]]
        print(f"Mlp {name} {M} x {K} -> {N}{', GELU' if act else ''} (tile {GEMM_TILES[tile]}, grid {grid}): "
              f"this tree {fmt('this')} ms" + (f", parent {fmt('parent')}" if not act else "")
              + f", addmm {fmt('addmm')}" + (f", addmm + GELU {fmt('addmm_gelu')}" if act else "")
              + f", parent's chain {fmt('chain')}; this / addmm {best['this'] / best['addmm']:.3f}; bound "
              f"{b_ms:.4f} ms ({by}; share this {b_ms / best['this']:.3f}, addmm {b_ms / best['addmm']:.3f}); "
              f"largest |this - f32 reference| {steps:.2f} (bf16 steps + 1e-6 of the largest){same}", flush=True)
        # this tree's entry at each tile the shape admits, in turns (t0, t1, t1, t0)
        forms = (0, 1) if N % 256 == 0 else (1,)
        by_tile, diff = {t: [] for t in forms}, {}
        for t in forms + forms[::-1]:
            tiles = -(-M // GEMM_TILES[t][0]) * -(-N // GEMM_TILES[t][1])
            launch, y = entry(libs["this"], t, min(tiles, H100_SMS))
            code = launch()
            torch.cuda.synchronize()
            if code != 0:
                raise RuntimeError(f"Mlp {name}: this tree's GEMM at tile {t} returned CUDA error {code}")
            diff[t] = (y.float() - outs["this"].float()).abs().max().item()
            by_tile[t].append(round(time_ms(launch, 10), 4))
        print("  by tile: " + ", ".join(f"{t} {GEMM_TILES[t]} {v} ms (max |y - planned| {diff[t]:.3g})"
                                       for t, v in by_tile.items()), flush=True)
        for k in ("this", "addmm", "addmm_gelu", "chain"):
            total[k] += per_step * best.get(k, best["addmm"])  # addmm + GELU: addmm at fc2
        total["bound"] += per_step * b_ms
        launches += per_step
        del x, w32, b, w, b_bf, outs, ref
        torch.cuda.empty_cache()
    print(f"Mlp products per serve step ({launches} launches, the better turn of each site): this tree "
          f"{total['this']:.3f} ms, addmm {total['addmm']:.3f}, addmm + GELU at fc1 {total['addmm_gelu']:.3f}, "
          f"the parent's chain {total['chain']:.3f}; bound {total['bound']:.3f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
