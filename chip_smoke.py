#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions.
2. Builds every hand-written kernel from ``unet_zoo_tpu_torch/ops/kernels/csrc``
   (one ``nvcc`` per source, all in parallel).
3. Holds K1 (``fused_up_concat_conv``) against its plain PyTorch version at
   the four 256px ``unet`` decoder-stage shapes and one non-square shape.
4. Serves full-width ``unet`` in bf16 through ``make_predictor`` at B=8,
   256x256, on the kernel path and on the plain module path (same seeded
   weights): compares them, confirms with ``torch.profiler`` that K1 ran on
   all four decoder stages, and times both paths and each stage.
5. Holds K4 (``fused_mkblock``) and K5 (``fused_softmax_morph``) against
   their plain versions at every distinct full-width ``mmunet`` shape and
   one odd shape each, each comparison scaled to what the output computes
   and shown to reject planted faults (K4: the cascade padded with gelu(t)
   instead of zero; K5: zero outputs, the wrong window, erosion padded
   with 0).
6. Serves full-width ``mmunet`` (base 96, bf16, B=8, 256x256) the same way:
   K4 must run on all 22 MKBlocks and K5 on all 6 morphology gates, by the
   launch counters and by the profiler; times both paths, and K4 and K5 at
   every launch shape against their plain versions and the bf16 module
   chains they replace.
7. Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
   as the last line.

Any failed check raises, so the script exits non-zero and prints no result.
It needs CUDA and the repository; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
SERVE_BATCH = 8
IMAGE = 256
# y [B, Cin, Hc, Wc] and skip [B, Cs, 2Hc, 2Wc] of unet's four decoder
# stages at 256px (Co = Cu = Cin / 2 = Cs)
STAGES = [(1024, 512, 16), (512, 256, 32), (256, 128, 64), (128, 64, 128)]
# mmunet (base 96) at 256px: (C, H=W, MKBlocks of that shape per forward)
MKBLOCK_SHAPES = [(96, 256, 4), (192, 128, 2), (192, 64, 4), (384, 32, 2), (768, 16, 2),
                  (768, 8, 2), (384, 16, 2), (192, 32, 2), (96, 128, 2)]
# (C, H=W, repeat, gates of that shape per forward): the four Up gates, the EFM pair
MORPH_SHAPES = [(768, 16, 2, 1), (384, 32, 2, 1), (192, 64, 2, 1), (192, 128, 2, 1),
                (96, 256, 1, 2)]
# kernel path vs plain path, relative L2 of mmunet logits. Both are bf16, but
# they round in different places through 22 residual blocks: the plain path
# rounds each of a block's ~15 ATen results, the kernel path keeps the
# depthwise cascade in f32 and rounds h0 and the hidden layer (measured
# 1.12e-2 at B=8/256px, H100; see PERF.md).
MMUNET_REL_L2 = 3e-2
# K4 against its plain version: the error beyond the output's bf16 rounding,
# as a share of the rms of the MLP branch (see k4_reading). Measured at most
# 6.8e-3 on the H100 at the full-width shapes; the planted border fault
# (mkblock_border_fault) reads 0.109 or more there (PERF.md).
K4_BRANCH_SHARE = 2e-2
# K5 against its plain version, relative: half a bf16 ulp (2^-8) plus f32
# differences of exp and of the sum over C (see k5_reading).
K5_REL = 2.0 ** -8 + 2.0 ** -16


def log(*a):
    print(*a, flush=True)


def stage_case(torch, gen, b, cin, cu, cs, co, hc, wc, device):
    """Random bf16 stage inputs with O(1) outputs, packed as the kernel takes them."""
    cl = torch.channels_last
    n = lambda *s: torch.randn(*s, generator=gen, device=device)
    y = n(b, cin, hc, wc).to(torch.bfloat16).contiguous(memory_format=cl)
    skip = n(b, cs, 2 * hc, 2 * wc).to(torch.bfloat16).contiguous(memory_format=cl)
    wt = (n(cin, 4 * cu) / cin ** 0.5).to(torch.bfloat16)
    wc_ = (n(9 * (cu + cs), co) * (2.0 / (9 * (cu + cs))) ** 0.5).to(torch.bfloat16)
    return (y, skip, wt, n(cu) * 0.1, wc_, 1.0 + 0.2 * n(co), 0.1 * n(co))


def cuda_ms(torch, fn, iters):
    """Mean ms of ``fn()`` over ``iters`` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def work(b, cin, cu, cs, co, hc, wc):
    """K1's operations and its least bytes: each input read once, the output
    written once (bf16 tensors and weights, f32 bt/scale/bias)."""
    hf, wf = 2 * hc, 2 * wc
    flops = 2 * (b * hc * wc * cin * 4 * cu + b * hf * wf * 9 * (cu + cs) * co)
    nbytes = (2 * (b * hc * wc * cin + b * hf * wf * cs + b * hf * wf * co
                   + cin * 4 * cu + 9 * (cu + cs) * co) + 4 * (cu + 2 * co))
    return flops, nbytes


def bound(flops, nbytes, f32_ops=0):
    """(ms, what bounds it): the least time the card could take for the work.
    ``flops`` run on the bf16 tensor cores, ``f32_ops`` on the CUDA cores;
    the two units overlap, so the slower of them bounds the operations."""
    t_ops = max(flops / PEAK_BF16_FLOPS, f32_ops / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def mkblock_work(b, c, h, w):
    """K4: (tensor-core FLOPs, f32 FLOPs, least bytes). The MLP's two GEMMs
    are 16*M*C^2 FLOPs; the cascade is 83 depthwise taps per channel chain
    per pixel (2 FLOPs each). Bytes: x read and out written once (bf16), the
    bf16 weights and the f32 taps, affines and biases once."""
    m, q = b * h * w, c // 4
    return (16 * m * c * c, 2 * 83 * q * m,
            2 * 2 * m * c + 2 * 8 * c * c + 4 * (89 * q + 5 * c))


def morph_work(b, c, h, w, k, repeat):
    """K5: (f32 operations, least bytes). Softmax about 5 operations per
    element, each round 2 separable passes of k-1 comparisons for d and for
    e; x read once, d and e written once (bf16)."""
    n = b * c * h * w
    return n * (5 + 4 * (k - 1) * repeat), 3 * 2 * n


def profile_forward(torch, fn):
    """Device events of one traced call of ``fn`` (synchronised)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def serve_times(torch, preds, x):
    """Median ms per forward on each path: 10 samples of 3 forwards, paths in turns."""
    times = {name: [] for name in preds}
    for fn in preds.values():
        for _ in range(3):
            fn(x)
    names = list(preds)
    for r in range(10):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(cuda_ms(torch, lambda: preds[name](x), 3))
    return times


def breakdown(torch, name, fn, forward_ms):
    """Log where one forward's device time goes, by kernel, and the idle share."""
    per = {}
    for e in profile_forward(torch, fn):
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(per.values())
    log(f"{name} path device time {busy:.4f} ms of {forward_ms:.4f} ms forward "
        f"(idle share {1 - busy / forward_ms:.3f}); top kernels:")
    for kname, ms in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {ms:8.4f} ms  {kname[:110]}")
    return busy


def random_mkblock(torch, c, dtype, device, seed):
    """An eval MKBlock (no attention tail) with seeded weights and BN off identity."""
    from unet_zoo_tpu_torch.models.mmunet import MKBlock
    from unet_zoo_tpu_torch.nn import init_weights

    blk = MKBlock(c, dtype=dtype, use_kernels=False)
    g = torch.Generator().manual_seed(seed)
    init_weights(blk, g)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=g)
    return blk.to(device).eval()


def bf16_input(torch, gen, shape, device, scale=1.0):
    x = scale * torch.randn(*shape, generator=gen, device=device)
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def k4_reading(torch, got, ref, x):
    """K4's error beyond its output rounding, as a share of the MLP branch:
    max over elements of (|got - ref| - 2^-8 |ref|) / rms(ref - x). The
    kernel rounds its output to bf16, at most half an ulp (2^-8 |ref|) off;
    what remains comes from h0 and hidden elements that the kernel and the
    plain version round to neighbouring bf16 values, where their two f32
    sums (taken in other orders) straddle a rounding midpoint."""
    excess = (got.float() - ref).abs() - 2.0 ** -8 * ref.abs()
    return (excess.max() / (ref - x.float()).pow(2).mean().sqrt()).item()


def k5_reading(got, ref):
    """K5's largest relative error, max |got - ref| / |ref| (softmax > 0)."""
    return ((got.float() - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()


def mkblock_border_fault(torch, x, taps, affine, w1, b1, w2, b2):
    """K4's plain version with the cascade's padding trap planted: the
    intermediates a and b are gelu(t) outside the image instead of zero, so
    the dw5 and dw7 convs see them in their padding. Rounded as the kernel
    rounds its output; the K4 comparison must reject it."""
    F = torch.nn.functional
    q = x.shape[1] // 4
    quarters = x.float().split(q, dim=1)
    aff = affine.view(6, 1, q, 1, 1)
    z, fill, outs, kbase = None, None, [], 0
    for i, k in enumerate((3, 5, 7)):
        wt = taps[kbase:kbase + k * k].t().reshape(q, 1, k, k)
        kbase += k * k
        inp = quarters[i] if z is None else z + quarters[i]
        inp = F.pad(inp, (k // 2,) * 4) if fill is None else F.pad(inp - fill, (k // 2,) * 4) + fill
        z = F.gelu(F.conv2d(inp, wt, groups=q) * aff[2 * i] + aff[2 * i + 1])
        fill = F.gelu(aff[2 * i + 1])
        outs.append(z)
    h0 = torch.cat(outs + [quarters[3]], dim=1).permute(0, 2, 3, 1).to(torch.bfloat16).float()
    hid = F.gelu(h0 @ w1.float() + b1).to(torch.bfloat16).float()
    return (x.float() + (hid @ w2.float() + b2).permute(0, 3, 1, 2)).to(torch.bfloat16)


def morph_faults(torch, x, repeat, d_ref, e_ref):
    """Planted K5 faults, each (name, got, ref): d or e all zero, the wrong
    window (5 for 7), and e re-padded with 0 instead of +inf each round."""
    from unet_zoo_tpu_torch.ops.kernels import morph as k5

    F = torch.nn.functional
    d5, e5 = k5.fused_softmax_morph_reference(x.float(), 5, repeat)
    e0 = torch.softmax(x.float(), dim=1)
    for _ in range(repeat):
        e0 = -F.max_pool2d(F.pad(-e0, (3, 3, 3, 3), value=0.0), 7, 1)
    return [("d zero", torch.zeros_like(d_ref), d_ref), ("e zero", torch.zeros_like(e_ref), e_ref),
            ("d 5x5", d5, d_ref), ("e 5x5", e5, e_ref),
            ("e 0-padded", e0.to(torch.bfloat16), e_ref)]


def check_k4_k5(torch, gen, device):
    """K4 and K5 against their plain versions (f32, TF32 off) at every
    distinct full-width shape and one odd shape, each beside planted faults
    that the same comparison must reject; returns the max abs errors."""
    from unet_zoo_tpu_torch.ops.kernels import mkblock as k4
    from unet_zoo_tpu_torch.ops.kernels import morph as k5

    k4_err = 0.0
    cases = [(2 if h >= 128 else SERVE_BATCH, c, h, h) for c, h, _ in MKBLOCK_SHAPES]
    cases.append((1, 32, 37, 29))  # odd: H, W not multiples of 8 or of the 16-pixel tile
    for b, c, h, w in cases:
        blk = random_mkblock(torch, c, torch.float32, "cpu", c + h)
        weights = [t.to(device) for t in k4.fold_mkblock_params(blk)]
        x = bf16_input(torch, gen, (b, c, h, w), device)
        got = k4.fused_mkblock(x, *weights)
        ref = k4.fused_mkblock_reference(x.float(), *weights)
        fault = mkblock_border_fault(torch, x, *weights)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got.float()).all()
        reading, fault_reading = k4_reading(torch, got, ref, x), k4_reading(torch, fault, ref, x)
        err = (got.float() - ref).abs().max().item()
        log(f"K4 x={[b, c, h, w]}: max_abs_err {err:.3e}; beyond output rounding "
            f"{reading:.3e} of the branch rms (limit {K4_BRANCH_SHARE:.0e}); planted border "
            f"fault {fault_reading:.3e}")
        if not reading <= K4_BRANCH_SHARE:
            raise AssertionError(f"K4 disagrees with its plain version: {reading}")
        if not fault_reading > K4_BRANCH_SHARE:
            raise AssertionError(f"the K4 comparison passed a planted fault: {fault_reading}")
        k4_err = max(k4_err, err)

    k5_err = 0.0
    cases = [(2 if h >= 128 else SERVE_BATCH, c, h, h) for c, h, _, _ in MORPH_SHAPES]
    cases.append((1, 24, 37, 29))
    for b, c, h, w in cases:
        x = bf16_input(torch, gen, (b, c, h, w), device, scale=2.0)
        for repeat in (1, 2):
            d, e = k5.fused_softmax_morph(x, 7, repeat)
            d_ref, e_ref = k5.fused_softmax_morph_reference(x.float(), 7, repeat)
            faults = morph_faults(torch, x, repeat, d_ref, e_ref)
            torch.cuda.synchronize()
            rel = {"d": k5_reading(d, d_ref), "e": k5_reading(e, e_ref)}
            caught = {name: k5_reading(got, ref) for name, got, ref in faults}
            log(f"K5 x={[b, c, h, w]} repeat={repeat}: max rel err d {rel['d']:.3e}, "
                f"e {rel['e']:.3e} (limit {K5_REL:.4e}); least planted fault "
                f"{min(caught.values()):.3e} ({min(caught, key=caught.get)})")
            if not max(rel.values()) <= K5_REL:
                raise AssertionError(f"K5 disagrees with its plain version: {rel}")
            if not min(caught.values()) > K5_REL:
                raise AssertionError(f"the K5 comparison passed a planted fault: {caught}")
            k5_err = max(k5_err, (d.float() - d_ref).abs().max().item(),
                         (e.float() - e_ref).abs().max().item())
    return k4_err, k5_err


def serve_mmunet(torch, gen, device):
    """Full-width mmunet on both paths: agreement, launches, rates, breakdown."""
    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.ops.kernels import mkblock as k4
    from unet_zoo_tpu_torch.ops.kernels import morph as k5
    from unet_zoo_tpu_torch.utils.serving import make_predictor

    x = torch.randn(SERVE_BATCH, 3, IMAGE, IMAGE, generator=gen, device=device)
    kern = create_model("mmunet", dtype=torch.bfloat16, seed=0)
    plain = create_model("mmunet", dtype=torch.bfloat16, seed=0, use_kernels=False)
    log(f"mmunet: {sum(p.numel() for p in kern.module.parameters()) / 1e6:.2f} M parameters")
    pred_k, pred_p = make_predictor(kern, None, "logits"), make_predictor(plain, None, "logits")

    k4.LAUNCHES["fused_mkblock"] = 0
    k5.LAUNCHES["fused_softmax_morph"] = 0
    logits_k = pred_k(x)
    torch.cuda.synchronize()
    launches = {"fused_mkblock": k4.LAUNCHES["fused_mkblock"],
                "fused_softmax_morph": k5.LAUNCHES["fused_softmax_morph"]}
    logits_p = pred_p(x)
    mask_k = make_predictor(kern, None, "mask")(x)
    mask_p = make_predictor(plain, None, "mask")(x)
    torch.cuda.synchronize()
    log(f"main path: K4 launches {launches['fused_mkblock']}, "
        f"K5 launches {launches['fused_softmax_morph']} in one mmunet forward")
    want = {"fused_mkblock": sum(n for *_, n in MKBLOCK_SHAPES),
            "fused_softmax_morph": sum(n for *_, n in MORPH_SHAPES)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    for t in (logits_k, logits_p):
        assert t.shape == (SERVE_BATCH, 1, IMAGE, IMAGE) and torch.isfinite(t.float()).all()
    lk, lp = logits_k.float(), logits_p.float()
    rel_l2 = ((lk - lp).norm() / lp.norm()).item()
    agree = (mask_k == mask_p).float().mean().item()
    # how far each bf16 path lies from float32 compute on the same bf16-rounded weights
    exact = create_model("mmunet", seed=0, use_kernels=False)
    lf = make_predictor(exact, None, "logits")(x).float()
    del exact
    dist = {name: ((t - lf).norm() / lf.norm()).item() for name, t in (("kernel", lk),
                                                                     ("plain", lp))}
    log(f"serve mmunet: logits std {lp.std().item():.4f}, rel L2 kernel vs plain "
        f"{rel_l2:.3e} (<= {MMUNET_REL_L2:.0e}), mask agreement {agree:.5f} (>= 0.99); "
        f"rel L2 to f32 compute: kernel path {dist['kernel']:.3e}, plain path "
        f"{dist['plain']:.3e}")
    if not (rel_l2 <= MMUNET_REL_L2 and agree >= 0.99):
        raise AssertionError("mmunet kernel path disagrees with the plain path")

    # every K4 launch is a cascade grid and an MLP: one fused grid (C = 96,
    # 192) or two GEMM grids
    events = profile_forward(torch, lambda: pred_k(x))
    count = lambda key: sum(key in e.name for e in events)
    seen = {key: count(key) for key in ("mkblock_cascade", "mkblock_mlp_fused", "mkblock_gemm",
                                         "softmax_morph_kernel")}
    log(f"profiler: {seen}")
    mlps = seen["mkblock_mlp_fused"] + seen["mkblock_gemm"] / 2
    if not (seen["mkblock_cascade"] == mlps == want["fused_mkblock"]
            and seen["softmax_morph_kernel"] == want["fused_softmax_morph"]):
        raise AssertionError("profiler did not see K4 on every MKBlock and K5 on every gate")

    times = serve_times(torch, {"kernel": pred_k, "plain": pred_p}, x)
    med = {k: statistics.median(v) for k, v in times.items()}
    rates = {k: SERVE_BATCH / (m / 1e3) for k, m in med.items()}
    for name in ("kernel", "plain"):
        q = statistics.quantiles(times[name], n=4)
        log(f"serve mmunet bf16 B={SERVE_BATCH} {IMAGE}px, {name} path: {rates[name]:.1f} img/s "
            f"(forward median {med[name]:.4f} ms, quartiles {q[0]:.4f}-{q[2]:.4f} ms)")
    busy = {name: breakdown(torch, name, lambda: fn(x), med[name])
            for name, fn in (("kernel", pred_k), ("plain", pred_p))}
    return launches, rates, med, busy, dict(rel_l2=rel_l2, mask_agreement=agree,
                                            rel_l2_to_f32=dist)


def time_k4_k5(torch, gen, device):
    """K4 and K5 at each launch shape of the B=8 forward: kernel, plain
    version, bound and the bf16 module chain each replaces."""
    from unet_zoo_tpu_torch.models.mmunet import softmax_morph
    from unet_zoo_tpu_torch.ops.kernels import mkblock as k4
    from unet_zoo_tpu_torch.ops.kernels import morph as k5
    from unet_zoo_tpu_torch.utils.serving import cast_params_for_inference

    k4_rows = []
    for c, h, n in MKBLOCK_SHAPES:
        b = SERVE_BATCH
        # the predictor's module path: bf16-rounded parameters, bf16 compute
        blk = cast_params_for_inference(random_mkblock(torch, c, torch.bfloat16, device, c + h))
        weights = k4.fold_mkblock_params(blk)
        x = bf16_input(torch, gen, (b, c, h, h), device)
        with torch.inference_mode():
            ms = cuda_ms(torch, lambda: k4.fused_mkblock(x, *weights), 20)
            plain_ms = cuda_ms(torch, lambda: k4.fused_mkblock_reference(x, *weights), 5)
            chain_ms = cuda_ms(torch, lambda: blk(x), 20)
        tc, f32, nbytes = mkblock_work(b, c, h, h)
        bound_ms, bound_by = bound(tc, nbytes, f32)
        k4_rows.append(dict(x=[b, c, h, h], launches=n, tc_flops=tc, f32_flops=f32,
                            bytes=nbytes, ms=ms, plain_ms=plain_ms, module_chain_ms=chain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            tflops=tc / ms / 1e9))
        log(f"K4 x={[b, c, h, h]} x{n}: {ms:.4f} ms ({tc / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, module chain {chain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")

    k5_rows = []
    for c, h, repeat, n in MORPH_SHAPES:
        b = SERVE_BATCH
        x = bf16_input(torch, gen, (b, c, h, h), device, scale=2.0)
        with torch.inference_mode():
            ms = cuda_ms(torch, lambda: k5.fused_softmax_morph(x, 7, repeat), 20)
            plain_ms = cuda_ms(torch, lambda: k5.fused_softmax_morph_reference(x, 7, repeat), 5)
            chain_ms = cuda_ms(torch, lambda: softmax_morph(x, repeat, False, False), 20)
        ops, nbytes = morph_work(b, c, h, h, 7, repeat)
        bound_ms, bound_by = bound(0, nbytes, ops)
        k5_rows.append(dict(x=[b, c, h, h], repeat=repeat, launches=n, f32_ops=ops,
                            bytes=nbytes, ms=ms, plain_ms=plain_ms, module_chain_ms=chain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            gbytes_per_s=nbytes / ms / 1e6))
        log(f"K5 x={[b, c, h, h]} repeat={repeat} x{n}: {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, module chain "
            f"{chain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return k4_rows, k5_rows


def per_forward(rows, key):
    """A per-launch quantity summed over one forward's launches."""
    return sum(r[key] * r["launches"] for r in rows)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from unet_zoo_tpu_torch import create_model
    from unet_zoo_tpu_torch.ops.kernels import build
    from unet_zoo_tpu_torch.ops.kernels import fused_up as k1
    from unet_zoo_tpu_torch.utils.serving import make_predictor

    # the f32 reference is exact f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build every kernel from source
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"build: {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for stem in paths:
        ptxas = (build.BUILD_DIR / f"{stem}.log")
        if ptxas.exists():
            log(ptxas.read_text().strip())

    # 3. K1 against its plain version, bf16 inputs, reference in f32
    gen = torch.Generator(device=device).manual_seed(0)
    cases = [(2, cin, cu, cu, cu, hc, hc) for cin, cu, hc in STAGES]
    cases.append((1, 96, 64, 32, 48, 8, 12))  # non-square, Co != Cu
    max_err = 0.0
    for b, cin, cu, cs, co, hc, wc in cases:
        args = stage_case(torch, gen, b, cin, cu, cs, co, hc, wc, device)
        got = k1.fused_up_concat_conv(*args).float()
        ref = k1.fused_up_concat_conv_reference(*[a.float() for a in args])
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got).all()
        err = (got - ref).abs().max().item()
        tol = 1e-2 * (1 + ref.abs().max().item())
        log(f"K1 y={[b, cin, hc, wc]} skip={[b, cs, 2 * hc, 2 * wc]} Co={co}: "
            f"max_abs_err {err:.3e} bound {tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version: {err} > {tol}")
        max_err = max(max_err, err)

    # 4. serve unet at full width, kernel path vs plain module path
    x = torch.randn(SERVE_BATCH, 3, IMAGE, IMAGE, generator=gen, device=device)
    kern = create_model("unet", dtype=torch.bfloat16, seed=0)
    plain = create_model("unet", dtype=torch.bfloat16, seed=0, use_kernels=False)
    pred_k, pred_p = make_predictor(kern, None, "logits"), make_predictor(plain, None, "logits")

    k1.LAUNCHES["fused_up_concat_conv"] = 0
    logits_k = pred_k(x)
    torch.cuda.synchronize()
    launches = k1.LAUNCHES["fused_up_concat_conv"]
    logits_p = pred_p(x)
    mask_k = make_predictor(kern, None, "mask")(x)
    mask_p = make_predictor(plain, None, "mask")(x)
    torch.cuda.synchronize()
    log(f"main path: K1 launches {launches} in one forward")
    if launches != len(STAGES):
        raise AssertionError(f"K1 ran {launches} times, expected {len(STAGES)}")
    for t in (logits_k, logits_p):
        assert t.shape == (SERVE_BATCH, 1, IMAGE, IMAGE) and torch.isfinite(t.float()).all()
    lk, lp = logits_k.float(), logits_p.float()
    rel_l2 = ((lk - lp).norm() / lp.norm()).item()
    agree = (mask_k == mask_p).float().mean().item()
    log(f"serve: logits std {lp.std().item():.4f}, rel L2 kernel vs plain {rel_l2:.3e} "
        f"(<= 1e-2), mask agreement {agree:.5f} (>= 0.99)")
    if not (rel_l2 <= 1e-2 and agree >= 0.99):
        raise AssertionError("kernel path disagrees with the plain path")

    # the profiler sees K1's two grids once per decoder stage
    kernels = [e for e in profile_forward(torch, lambda: pred_k(x)) if "fused_up_gemm" in e.name]
    kernels.sort(key=lambda e: e.time_range.start)
    convt = [e for e in kernels if "<false" in e.name or "ILb0E" in e.name]
    conv3 = [e for e in kernels if e not in convt]
    log(f"profiler: {len(convt)} ConvT grids, {len(conv3)} conv3x3 grids: "
        + ", ".join(f"{a.time_range.elapsed_us():.1f}+{c.time_range.elapsed_us():.1f} us"
                    for a, c in zip(convt, conv3)))
    if len(convt) != len(STAGES) or len(conv3) != len(STAGES):
        raise AssertionError("profiler did not see K1 on every decoder stage")

    # serving rate, both paths, in turns; each sample is 3 forwards back to back
    times = serve_times(torch, {"kernel": pred_k, "plain": pred_p}, x)
    med = {k: statistics.median(v) for k, v in times.items()}
    rates = {k: SERVE_BATCH / (m / 1e3) for k, m in med.items()}
    for name in ("kernel", "plain"):
        q = statistics.quantiles(times[name], n=4)
        log(f"serve unet bf16 B={SERVE_BATCH} {IMAGE}px, {name} path: {rates[name]:.1f} img/s "
            f"(forward median {med[name]:.4f} ms, quartiles {q[0]:.4f}-{q[2]:.4f} ms)")

    # where a forward's device time goes, by kernel, on each path
    for name, fn in (("kernel", pred_k), ("plain", pred_p)):
        breakdown(torch, name, lambda: fn(x), med[name])

    # each stage at the serving shapes: K1, its plain version, the cuDNN chain
    stages = []
    for cin, cu, hc in STAGES:
        b, cs, co = SERVE_BATCH, cu, cu
        args = stage_case(torch, gen, b, cin, cu, cs, co, hc, hc, device)
        y, skip, wt, bt, wc, sc, bi = args
        wt4 = wt.reshape(cin, 2, 2, cu).permute(0, 3, 1, 2).contiguous()
        wc4 = wc.reshape(3, 3, cu + cs, co).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bt16, sc4, bi4 = bt.to(torch.bfloat16), sc.view(1, -1, 1, 1), bi.view(1, -1, 1, 1)

        def chain():
            up = F.conv_transpose2d(y, wt4, bt16, stride=2)
            z = F.conv2d(torch.cat([up, skip], dim=1), wc4, padding=1)
            return torch.relu(z.float() * sc4 + bi4).to(torch.bfloat16)

        ms = cuda_ms(torch, lambda: k1.fused_up_concat_conv(*args), 20)
        plain_ms = cuda_ms(torch, lambda: k1.fused_up_concat_conv_reference(*args), 5)
        chain_ms = cuda_ms(torch, chain, 20)
        flops, nbytes = work(b, cin, cu, cs, co, hc, hc)
        bound_ms, bound_by = bound(flops, nbytes)
        stages.append(dict(y=[b, cin, hc, hc], skip=[b, cs, 2 * hc, 2 * hc], co=co,
                           flops=flops, bytes=nbytes, ms=ms, plain_ms=plain_ms,
                           cudnn_chain_ms=chain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           tflops=flops / ms / 1e9))
        log(f"stage y={[b, cin, hc, hc]}: K1 {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, cuDNN chain {chain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")

    # 5-6. mmunet: K4 and K5 checks, serving, per-shape timings
    k4_err, k5_err = check_k4_k5(torch, gen, device)
    mm_launches, mm_rates, mm_med, mm_busy, mm_agreement = serve_mmunet(torch, gen, device)
    k4_rows, k5_rows = time_k4_k5(torch, gen, device)

    total = lambda key: sum(s[key] for s in stages)
    bound_ms, bound_by = bound(total("flops"), total("bytes"))
    k4_bound = bound(per_forward(k4_rows, "tc_flops"), per_forward(k4_rows, "bytes"),
                     per_forward(k4_rows, "f32_flops"))
    k5_bound = bound(0, per_forward(k5_rows, "bytes"), per_forward(k5_rows, "f32_ops"))
    mm_serving = dict(serve_img_per_s=mm_rates, forward_ms=mm_med, device_busy_ms=mm_busy,
                      **mm_agreement)
    log(json.dumps({"kernels": [{
        "name": "fused_up_concat_conv",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/fused_up.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/fused_up.py:192",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "cudnn_chain_ms": total("cudnn_chain_ms"),
        "serve_img_per_s": rates,
        "stages": stages,
    }, {
        "name": "fused_mkblock",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/mkblock.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/mkblock.py:149",
        "launches": mm_launches["fused_mkblock"],
        "max_abs_err": k4_err,
        "ms": per_forward(k4_rows, "ms"),
        "plain_ms": per_forward(k4_rows, "plain_ms"),
        "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1],
        "library_ms": None,
        "module_chain_ms": per_forward(k4_rows, "module_chain_ms"),
        "mmunet": mm_serving,
        "shapes": k4_rows,
    }, {
        "name": "fused_softmax_morph",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/ops/kernels/csrc/morph.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/morph.py:109",
        "launches": mm_launches["fused_softmax_morph"],
        "max_abs_err": k5_err,
        "ms": per_forward(k5_rows, "ms"),
        "plain_ms": per_forward(k5_rows, "plain_ms"),
        "bound_ms": k5_bound[0],
        "bound_by": k5_bound[1],
        "library_ms": None,
        "module_chain_ms": per_forward(k5_rows, "module_chain_ms"),
        "shapes": k5_rows,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
