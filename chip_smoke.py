#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions.
2. Builds every hand-written kernel from ``unet_zoo_tpu_torch/ops/kernels/csrc``.
3. Holds K1 (``fused_up_concat_conv``) against its plain PyTorch version at
   the four 256px ``unet`` decoder-stage shapes and one non-square shape.
4. Serves full-width ``unet`` in bf16 through ``make_predictor`` at B=8,
   256x256, on the kernel path and on the plain module path (same seeded
   weights): compares them, confirms with ``torch.profiler`` that K1 ran on
   all four decoder stages, and times both paths and each stage.
5. Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
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
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
SERVE_BATCH = 8
IMAGE = 256
# y [B, Cin, Hc, Wc] and skip [B, Cs, 2Hc, 2Wc] of unet's four decoder
# stages at 256px (Co = Cu = Cin / 2 = Cs)
STAGES = [(1024, 512, 16), (512, 256, 32), (256, 128, 64), (128, 64, 128)]


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


def bound(flops, nbytes):
    """(ms, what bounds it): the least time the card could take for the work."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred_k(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if "fused_up_gemm" in e.name
               and e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.time_range.start)
    convt = [e for e in kernels if "<false" in e.name or "ILb0E" in e.name]
    conv3 = [e for e in kernels if e not in convt]
    log(f"profiler: {len(convt)} ConvT grids, {len(conv3)} conv3x3 grids: "
        + ", ".join(f"{a.time_range.elapsed_us():.1f}+{c.time_range.elapsed_us():.1f} us"
                    for a, c in zip(convt, conv3)))
    if len(convt) != len(STAGES) or len(conv3) != len(STAGES):
        raise AssertionError("profiler did not see K1 on every decoder stage")

    # serving rate, both paths, in turns; each sample is 3 forwards back to back
    times = {"kernel": [], "plain": []}
    for fn in (pred_k, pred_p):
        for _ in range(3):
            fn(x)
    for r in range(10):
        for name, fn in (("kernel", pred_k), ("plain", pred_p)) if r % 2 == 0 else \
                (("plain", pred_p), ("kernel", pred_k)):
            times[name].append(cuda_ms(torch, lambda: fn(x), 3))
    med = {k: statistics.median(v) for k, v in times.items()}
    rates = {k: SERVE_BATCH / (m / 1e3) for k, m in med.items()}
    for name in ("kernel", "plain"):
        q = statistics.quantiles(times[name], n=4)
        log(f"serve unet bf16 B={SERVE_BATCH} {IMAGE}px, {name} path: {rates[name]:.1f} img/s "
            f"(forward median {med[name]:.4f} ms, quartiles {q[0]:.4f}-{q[2]:.4f} ms)")

    # where a forward's device time goes, by kernel, on each path
    for name, fn in (("kernel", pred_k), ("plain", pred_p)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy = sum(per.values())
        log(f"{name} path device time {busy:.4f} ms of {med[name]:.4f} ms forward "
            f"(idle share {1 - busy / med[name]:.3f}); top kernels:")
        for kname, ms in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
            log(f"  {ms:8.4f} ms  {kname[:110]}")

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

    total = lambda key: sum(s[key] for s in stages)
    bound_ms, bound_by = bound(total("flops"), total("bytes"))
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
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
