"""Time the attention kernel on the card against its bound, its plain
version and a library call, at the shapes the serving path gives it.

    python3 -m newsreclib_tpu_torch.kernel_bench [--baseline OLD.cu] [--json OUT.jsonl]
    python3 -m newsreclib_tpu_torch.kernel_bench --backward [--json OUT.jsonl]

For every (U, L) of the NRMS serving epoch (D = 300, 15 heads of 20) and the
two extra shapes (1024, 30) and (256, 50), in float32 and bfloat16:

* the kernel is held against ``mhsa_plain`` on the same inputs (float32
  atol/rtol 1e-5, bfloat16 atol 2e-2 / rtol 1e-2);
* ``ms`` is the kernel's device time per launch, summed from
  ``torch.profiler``'s CUDA kernel records over 20 launches (after 3
  warm-ups), so that the Python checks and the ctypes call do not enter;
  ``event_ms`` is the time per call of 20 back-to-back calls by CUDA events,
  host cost included;
* the inputs rotate over enough copies that one pass over them moves at
  least 256 MB, more than the 50 MB L2, so that each launch finds its
  inputs in device memory, as the bound assumes;
* ``library_ms`` is one ``F.scaled_dot_product_attention`` call on the same
  data, laid out for it: contiguous (U, H, L, hd') q, k and v zero-padded to
  hd' = 24 (a multiple of 8), the boolean key mask, ``scale = 1 / sqrt(20)``,
  with ``SDPBackend.EFFICIENT_ATTENTION`` forced so that a refusal raises
  rather than falling back to the math backend.  It is a yardstick only: the
  port never calls SDPA (and SDPA gives NaN on a fully masked row);
* ``bound_ms`` is the larger of the bytes (qkv and mask read once, the
  context written once, at 3.35 TB/s) and the q.k and p.v operations (at
  989 TFLOP/s bf16 or 67 TFLOP/s f32).

``--backward`` times forward + backward instead, at the shapes the NRMS
train step gives the kernel (``TRAIN_SHAPES``: batch 64 and batch 256 of
``profile_train.py``), in bfloat16 and float32.  The output is held against
``mhsa_plain`` and the gradient against autograd of it (same tolerances;
``fwd_max_abs_err``, ``max_abs_err``).  Forward + backward, each as
``torch.autograd.grad`` of the output against a fixed output gradient:
``FusedSmallMHSA`` (the forward kernel, then the backward kernel; ``ms``),
autograd of ``mhsa_plain`` (``plain_ms``) and SDPA with the efficient
backend forced (``library_ms``).  The backward alone: the backward kernel
(``bwd_ms``) and ``mhsa_backward``, its plain version (``plain_bwd_ms``),
timed in turns (kernel, plain, plain, kernel), and SDPA's backward on a
saved forward (``library_bwd_ms``).  ``bound_ms`` counts qkv, the mask and
the context once each way plus the output gradient and dqkv, and the
products of the forward (q.k, p.v) and of the backward (dP, dQ, dK, dV):
12 U H L^2 hd operations.  ``bwd_bound_ms`` is the backward alone's: qkv,
the mask and dO read, dqkv written, and q.k recomputed with the four
backward products, 10 U H L^2 hd operations.

``--baseline`` builds another version of ``csrc/mhsa.cu`` (same C entry
point), checks it the same way and times it in turns with the kernel
(kernel, baseline, baseline, kernel), so that two versions are compared on
one card in one run.  ``--unchecked`` records the baseline's error without
holding it to the tolerance, for diagnostic builds that do not compute the
function (for instance the kernel with its compute loop removed, which
times the staging and the write-out alone).  Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

D, H = 300, 15
SERVING_SHAPES = [(4096, 16), (2272, 16), (1825, 30), (512, 50)]
EXTRA_SHAPES = [(1024, 30), (256, 50)]
# (U, L) of the train step's attentions (TrainBatcher over the bench workload
# of seed 0, split at 16): batch 64 alternates (3584, 16) + (512, 30) and
# (1792, 16) + (256, 30), with (64, 50) for the user encoder; batch 256 gives
# (7168, 16) + (1024, 30) and (256, 50).
TRAIN_SHAPES = [(3584, 16), (1792, 16), (512, 30), (256, 30), (64, 50),
                (7168, 16), (1024, 30), (256, 50)]
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores, bf16 tensor cores
ROTATE_BYTES = 256 << 20
LIBRARY_BACKEND = "EFFICIENT_ATTENTION"
ITERS, WARMUP = 20, 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[1]


def mhsa_inputs(u, l, dtype, seed):
    """qkv ~ N(0, 1) and a prefix key mask of random length, with row 0 (the
    padding article) fully masked, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((u, l, 3 * D), generator=g, device="cuda").to(dtype)
    lens = torch.randint(1, l + 1, (u,), generator=g, device="cuda")
    mask = torch.arange(l, device="cuda")[None, :] < lens[:, None]
    mask[0] = False
    return qkv, mask.contiguous()


def bound(u, l, name, part="forward") -> tuple:
    """(least ms on the card, "bytes" or "operations") for the attention of
    (U, L) in type ``name``: its ``"forward"``, its ``"backward"`` alone or
    ``"both"`` (see module doc)."""
    es = 4 if name == "float32" else 2
    qkv, ctx, mask = u * l * 3 * D * es, u * l * D * es, u * l
    product = 2 * u * H * l * l * (D // H)  # operations of one (L, L) x (L, hd) product
    nbytes, flops = {
        "forward": (qkv + mask + ctx, 2 * product),
        "backward": (qkv + mask + ctx + qkv, 5 * product),
        "both": (2 * (qkv + mask + ctx) + qkv, 6 * product),
    }[part]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def event_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Milliseconds per call of ``fn(i)`` over ``iters`` back-to-back calls,
    by CUDA events (host cost included when it exceeds the device's)."""
    for i in range(warmup):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The profiler's device-side records of kernels and copies, summed by
    name: every CUDA record but the user-annotation ranges (a
    ``record_function`` range, such as ``Optimizer.step#Adam.step``, also
    appears on the device timeline, spanning its kernels and the gaps
    between them)."""
    return [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and not e.is_user_annotation]


def device_ms(fn, iters: int = ITERS, warmup: int = WARMUP, attempts: int = 3) -> float:
    """Device milliseconds per call of ``fn(i)``: the self time of every CUDA
    kernel it launched, from ``torch.profiler``, over ``iters`` calls.  A
    window in which the profiler recorded no kernel at all (seen once on the
    H100) is profiled again, up to ``attempts`` windows."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in device_events(prof))
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError(f"torch.profiler recorded no device time in {attempts} windows")


def raw_launcher(lib: ctypes.CDLL):
    """``(qkv, mask, num_heads) -> out`` through another build's
    ``nrl_mhsa_fwd``, with the wrapper's allocation and no launch count."""
    fn = lib.nrl_mhsa_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dtypes = {torch.float32: 0, torch.bfloat16: 1}

    def launch(qkv, mask, num_heads):
        u, l, d3 = qkv.shape
        out = torch.empty((u, l, d3 // 3), dtype=qkv.dtype, device=qkv.device)
        rc = fn(qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), u, l, d3 // 3, num_heads,
                dtypes[qkv.dtype], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline nrl_mhsa_fwd failed: cudaError {rc}")
        return out

    return launch


def sdpa_call(qkv, mask, num_heads):
    """The library yardstick's inputs for ``qkv`` and a call that runs it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    u, l, d3 = qkv.shape
    hd = d3 // 3 // num_heads
    pad = -hd % 8
    q, k, v = (F.pad(t, (0, pad)).contiguous()
               for t in qkv.view(u, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4))
    m = mask[:, None, None, :]
    scale = 1.0 / math.sqrt(hd)

    def call():
        with sdpa_kernel(getattr(SDPBackend, LIBRARY_BACKEND)):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

    return call


def _rotated(qkv, mask, extra=()):
    """Copies of the inputs enough to move ROTATE_BYTES in one pass."""
    nbytes = qkv.numel() * qkv.element_size() * 4 // 3
    n = max(1, math.ceil(ROTATE_BYTES / nbytes))
    return [(qkv, mask, *extra)] + [(qkv.clone(), mask.clone(), *(e.clone() for e in extra))
                                    for _ in range(n - 1)]


def measure_shape(u, l, dtype, variants, library=True, unchecked=()) -> dict:
    """Check each ``(name, launch)`` of ``variants`` against ``mhsa_plain``
    at (U, L), then time them in turns (forward, then backward order), the
    plain version and the library call.  The first variant's numbers are
    ``ms`` / ``event_ms`` / ``max_abs_err``, the others' are prefixed with
    their name.  Variants named in ``unchecked`` are not held to the
    tolerance."""
    from newsreclib_tpu_torch.ops.mhsa import mhsa_plain

    name = dtype_name(dtype)
    qkv, mask = mhsa_inputs(u, l, dtype, seed=u + l)
    want = mhsa_plain(qkv, mask, H).float()
    limit = ATOL[name] + RTOL[name] * want.abs()
    rec = dict(U=u, L=l, dtype=name)
    for i, (vname, launch) in enumerate(variants):
        got = launch(qkv, mask, H)
        torch.cuda.synchronize()
        if got.shape != (u, l, D) or got.dtype != dtype:
            raise AssertionError(f"{vname} output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - want).abs()
        if vname in unchecked:
            pass
        elif not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{vname} output not finite at U={u} L={l} {name}")
        elif not bool((err <= limit).all()):
            raise AssertionError(f"{vname} != plain at U={u} L={l} {name}: "
                                 f"max abs err {err.max().item()}")
        rec[("" if i == 0 else vname + "_") + "max_abs_err"] = err.max().item()
    del want, limit

    sets = _rotated(qkv, mask)
    n = len(sets)
    times = {vname: [] for vname, _ in variants}
    for vname, launch in variants + variants[::-1]:
        times[vname].append((device_ms(lambda i: launch(*sets[i % n], H)),
                             event_ms(lambda i: launch(*sets[i % n], H))))
    for i, (vname, _) in enumerate(variants):
        prefix = "" if i == 0 else vname + "_"
        rec[prefix + "ms"] = sum(t[0] for t in times[vname]) / len(times[vname])
        rec[prefix + "event_ms"] = sum(t[1] for t in times[vname]) / len(times[vname])
        rec[prefix + "ms_runs"] = [t[0] for t in times[vname]]
    rec["plain_ms"] = device_ms(lambda i: mhsa_plain(*sets[i % n], H))
    if library:
        calls = [sdpa_call(x, m, H) for x, m in sets]
        calls[0]()
        torch.cuda.synchronize()
        rec["library_ms"] = device_ms(lambda i: calls[i % n]())
        rec["library_backend"] = LIBRARY_BACKEND
        del calls
    rec["bound_ms"], rec["bound_by"] = bound(u, l, name)
    rec["rotated_sets"] = n
    return rec


def sdpa_grad_call(qkv, mask, num_heads, grad_out, backward_only=False):
    """SDPA forward + backward (efficient backend forced) on the layout of
    ``sdpa_call``, as one call returning (dq, dk, dv); with
    ``backward_only``, the forward runs once here and the call is its
    backward alone."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    u, l, d3 = qkv.shape
    hd = d3 // 3 // num_heads
    pad = -hd % 8
    q, k, v = (F.pad(t, (0, pad)).contiguous().requires_grad_(True)
               for t in qkv.view(u, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4))
    g = F.pad(grad_out.view(u, l, num_heads, hd).transpose(1, 2), (0, pad)).contiguous()
    m = mask[:, None, None, :]
    scale = 1.0 / math.sqrt(hd)

    def forward():
        with sdpa_kernel(getattr(SDPBackend, LIBRARY_BACKEND)):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

    if backward_only:
        out = forward()
        return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    return lambda: torch.autograd.grad(forward(), (q, k, v), g)


def _fused_grad(x, mask, grad_out):
    from newsreclib_tpu_torch.ops.mhsa import FusedSmallMHSA

    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(FusedSmallMHSA.apply(x, mask, H), x, grad_out)[0]


def _plain_grad(x, mask, grad_out):
    from newsreclib_tpu_torch.ops.mhsa import mhsa_plain

    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(mhsa_plain(x, mask, H), x, grad_out)[0]


def check_backward(u, l, dtype, backward=None):
    """Hold ``FusedSmallMHSA`` at (U, L) against the plain version with a
    random output gradient: its output (the forward kernel's) against
    ``mhsa_plain`` and its gradient (the backward kernel's) against autograd
    of ``mhsa_plain``, each within ATOL + RTOL * |plain|.  ``backward(qkv,
    mask, num_heads, grad_out)``, when given, stands in for the gradient (a
    planted fault, to show that the check can fail).  Returns ``(max abs
    output err, max abs gradient err, (qkv, mask, grad_out))``."""
    from newsreclib_tpu_torch.ops.mhsa import FusedSmallMHSA, mhsa_plain

    name = dtype_name(dtype)
    qkv, mask = mhsa_inputs(u, l, dtype, seed=u + l)
    g = torch.randn((u, l, D), generator=torch.Generator(device="cuda").manual_seed(l),
                    device="cuda").to(dtype)
    x = qkv.detach().requires_grad_(True)
    out = FusedSmallMHSA.apply(x, mask, H)
    got = torch.autograd.grad(out, x, g)[0] if backward is None else backward(qkv, mask, H, g)
    want = _plain_grad(qkv, mask, g).float()
    want_out = mhsa_plain(qkv, mask, H).float()
    torch.cuda.synchronize()
    errs = []
    for what, a, b in (("output", out.detach().float(), want_out), ("gradient", got.float(), want)):
        err = (a - b).abs()
        if not bool(torch.isfinite(a).all()) or not bool(
                (err <= ATOL[name] + RTOL[name] * b.abs()).all()):
            raise AssertionError(f"FusedSmallMHSA {what} != plain at U={u} L={l} {name}: "
                                 f"max abs err {err.max().item()}")
        errs.append(err.max().item())
    return errs[0], errs[1], (qkv, mask, g)


def measure_backward(u, l, dtype) -> dict:
    """Forward + backward and the backward alone at (U, L):
    ``check_backward``, then the times of the module doc."""
    from newsreclib_tpu_torch.ops.mhsa import _backward, mhsa_backward

    fwd_err, err, (qkv, mask, g) = check_backward(u, l, dtype)
    rec = dict(U=u, L=l, dtype=dtype_name(dtype), max_abs_err=err, fwd_max_abs_err=fwd_err)
    sets = _rotated(qkv, mask, (g,))
    n = len(sets)
    runs = [device_ms(lambda i: _fused_grad(*sets[i % n])) for _ in range(2)]
    rec["ms"], rec["ms_runs"] = sum(runs) / 2, runs
    rec["event_ms"] = event_ms(lambda i: _fused_grad(*sets[i % n]))
    backward = {"kernel": lambda i: _backward(sets[i % n][0], sets[i % n][1], H, sets[i % n][2]),
                "plain": lambda i: mhsa_backward(sets[i % n][0], sets[i % n][1], H,
                                                 sets[i % n][2])}
    times = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        times[name].append(device_ms(backward[name]))
    rec["bwd_ms"], rec["bwd_ms_runs"] = sum(times["kernel"]) / 2, times["kernel"]
    rec["plain_bwd_ms"], rec["plain_bwd_ms_runs"] = sum(times["plain"]) / 2, times["plain"]
    rec["bwd_event_ms"] = event_ms(backward["kernel"])
    rec["plain_ms"] = device_ms(lambda i: _plain_grad(*sets[i % n]))
    for key, only in (("library_ms", False), ("library_bwd_ms", True)):
        calls = [sdpa_grad_call(x, m, H, go, backward_only=only) for x, m, go in sets]
        calls[0]()
        torch.cuda.synchronize()
        rec[key] = device_ms(lambda i: calls[i % n]())
        del calls
    rec["library_backend"] = LIBRARY_BACKEND
    rec["bound_ms"], rec["bound_by"] = bound(u, l, rec["dtype"], "both")
    rec["bwd_bound_ms"], rec["bwd_bound_by"] = bound(u, l, rec["dtype"], "backward")
    rec["rotated_sets"] = n
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="another version of csrc/mhsa.cu to time against")
    ap.add_argument("--unchecked", action="store_true",
                    help="do not hold the baseline to the tolerance (diagnostic builds)")
    ap.add_argument("--backward", action="store_true",
                    help="time forward + backward at the train step's shapes")
    ap.add_argument("--json", type=Path, help="also write the records here, one per line")
    args = ap.parse_args(argv)
    if args.backward and args.baseline is not None:
        ap.error("--backward takes no --baseline")
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 1
    from newsreclib_tpu_torch.ops import build, mhsa

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(["mhsa"])
    variants = [("kernel", mhsa.fused_small_mhsa)]
    if args.baseline is not None:
        variants.append(("baseline", raw_launcher(build.load_source(args.baseline))))
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        for u, l in (TRAIN_SHAPES if args.backward else SERVING_SHAPES + EXTRA_SHAPES):
            if args.backward:
                rec = measure_backward(u, l, dtype)
            else:
                rec = measure_shape(u, l, dtype, variants,
                                    unchecked=("baseline",) if args.unchecked else ())
            rec["card"] = card
            print("kernel_bench " + json.dumps(rec), flush=True)
            records.append(rec)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text("".join(json.dumps(r) + "\n" for r in records))
    cols = ["U", "L", "dtype", "ms", "bound_ms", "plain_ms", "library_ms", "event_ms",
            "max_abs_err"]
    cols[4:4] = (["bwd_ms", "bwd_bound_ms", "plain_bwd_ms", "library_bwd_ms"] if args.backward
                 else ["baseline_ms"])
    print(" | ".join(cols))
    for r in records:
        print(" | ".join(str(r.get(c, "")) for c in cols))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
