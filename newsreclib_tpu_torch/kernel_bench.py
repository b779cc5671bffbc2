"""Time the attention kernel on the card against its bound, its plain
version and a library call, at the shapes the serving path gives it.

    python3 -m newsreclib_tpu_torch.kernel_bench [--baseline OLD.cu] [--dtype T]
        [--shapes {all,manner,plm_statfix,long,narrow}] [--only U,L,D,H ...] [--json OUT.jsonl]
    python3 -m newsreclib_tpu_torch.kernel_bench --backward [--baseline OLD.cu] [--dtype T]
        [--shapes {all,manner,plm_statfix,long,narrow}] [--json OUT.jsonl]
    python3 -m newsreclib_tpu_torch.kernel_bench --components [--baseline OLD.cu] [--dtype T]
        [--shapes {all,manner,plm_statfix,long,narrow}] [--json OUT.jsonl]

For every (U, L) of the NRMS serving epoch (D = 300, 15 heads of 20), the
two extra shapes (1024, 30) and (256, 50), the zoo's user-encoder shapes
(``ZOO_SHAPES``: MINS's 6 heads of 50, CenNewsRec's and CAUM's D = 400 with
20 heads), ``PLM_SHAPES`` (the PLM tower's MHSA, 16 heads of 48 over 768
at L = 96 and 32 with U = 512, and CAUM's default head dim 100) and
``MANNER_SHAPES`` (MANNeR's title + abstract attention, 15 heads of 20 at L
= 66 to 82), in float32 and bfloat16 (``--shapes manner``: the MANNeR
shapes alone; ``--shapes plm_statfix``: ``plm_statfix_shapes()``, the PLM
head's and the user encoder's attentions, 16 heads of 48 over 768, in the
train steps of ``nrms_statfix_plm_supconloss``; ``--shapes long``:
``LONG_SHAPES``, the kernel's long instances, L above 128 and head dims
beyond the wide instances' box):

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
  989 TFLOP/s bf16 or 67 TFLOP/s f32, the CUDA cores' rate);
  ``pct_of_bound`` is ``bound_ms`` as a percentage of ``ms``.  A float32
  record also gives ``tf32x3_bound_ms`` (and its ``tf32x3_pct_of_bound``):
  the operations at 165 TFLOP/s, split TF32 on the tensor cores (three
  TF32 products at 495 TFLOP/s for one f32 product, as the kernel's f32
  instances run them), which moves the least time where the operations
  bound it.

``--backward`` times forward + backward instead, at the shapes the NRMS
train step gives the kernel (``TRAIN_SHAPES``: batch 64 and batch 256 of
``profile_train.py``) and the global-row route's (``RANK_SHAPES``; both
``NARROW_BWD_SHAPES``, the narrow bf16 backward's, ``--shapes narrow``), at
``ZOO_SHAPES``, ``PLM_SHAPES`` and
``MANNER_SHAPES``, in bfloat16
and float32.  The output is held against
``mhsa_plain`` and the gradient against autograd of it (same tolerances;
``fwd_max_abs_err``, ``max_abs_err``).  Forward + backward, each as
``torch.autograd.grad`` of the output against a fixed output gradient:
``FusedSmallMHSA`` (the forward kernel, then the backward kernel; ``ms``),
autograd of ``mhsa_plain`` (``plain_ms``) and SDPA with the efficient
backend forced (``library_ms``).  The backward alone: the backward kernel
(``bwd_ms``) and ``mhsa_backward``, its plain version (``plain_bwd_ms``),
timed in turns (kernel, plain, plain, kernel), and SDPA's backward on a
saved forward (``library_bwd_ms``).  The forward alone: the forward kernel
(``fwd_ms``), ``mhsa_plain`` (``plain_fwd_ms``) and SDPA's forward
(``library_fwd_ms``), against ``fwd_bound_ms``.  ``bound_ms`` counts qkv, the mask and
the context once each way plus the output gradient and dqkv, and the
products of the forward (q.k, p.v) and of the backward (dP, dQ, dK, dV):
12 U H L^2 hd operations.  ``bwd_bound_ms`` is the backward alone's: qkv,
the mask and dO read, dqkv written, and q.k recomputed with the four
backward products, 10 U H L^2 hd operations.  Each of the three times
gets its ``pct_of_bound`` (``bwd_pct_of_bound``, ``fwd_pct_of_bound``) and,
in float32, its split-TF32 bound as above.

``--components`` times nothing: it splits the backward kernel's gradient
into dQ, dK and dV and gives, for each, its largest error over the
tolerance against autograd of ``mhsa_plain``, ``mhsa_backward`` and a
float64 reference, and that of autograd of ``mhsa_plain`` itself against
float64 (``gradient_components``): where the plain version is itself
further from float64 than the tolerance, a kernel can pass the check only
by rounding as it does.

``--baseline`` builds another version of ``csrc/mhsa.cu`` (same C entry
points), checks it the same way and times it in turns with the kernel
(kernel, baseline, baseline, kernel) at every shape it takes (a shape its
shape rule refuses gets "refused" in its ``baseline_*`` keys), so that two
versions are compared on one card in one run: the forward (``baseline_ms``) or, with ``--backward``,
the forward + backward (``baseline_ms``, the baseline's forward then its
backward), the backward alone (``baseline_bwd_ms``, in turns with the
kernel and the plain version) and the forward alone
(``baseline_fwd_ms``).  ``--unchecked`` records the baseline's error without
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
# (U, L) of the global-row route's attentions (``chip_smoke.global_row_shapes``
# at batch 64, two ranks): the densified table of title rows and one rank's
# users.  With TRAIN_SHAPES, the narrow bf16 backward's shapes
# (``NARROW_BWD_SHAPES``, ``--shapes narrow``).
RANK_SHAPES = [(4096, 30), (32, 50)]
NARROW_BWD_SHAPES = TRAIN_SHAPES + RANK_SHAPES
# (U, L, D, heads) of the other GloVe models' user encoders at batch 64, K =
# 4: MINS (6 heads of 50, the wide instances), CenNewsRec (D = 400, 20 heads)
# and CAUM (the 5 candidates folded into the batch).
ZOO_SHAPES = [(64, 50, 300, 6), (64, 50, 400, 20), (320, 50, 400, 20)]
# (U, L, D, heads) of the PLM tower's MHSA (16 heads of 48 over 768) at the
# JAX package's PLM operating point (U = 512 news rows), at PLM-mode title
# length 96 (``tokenizer_max_len``) and at 32, and CAUM's user encoder at its
# default of 4 heads over 400 (head dim 100): the wide instances beyond the
# earlier box (L <= 64, head dim <= 64).
PLM_SHAPES = [(512, 96, 768, 16), (512, 32, 768, 16), (64, 50, 400, 4)]
# (U, L, D, heads) of MANNeR's text attention (title and abstract side by
# side, 15 heads of 20: the wide instances, L above 64): the CR module's
# train step at batch 64 (the short segment 16 + 50, the tail 32 + 50 on
# the statfix data) and the A-module's batch of 64 untrimmed articles
# (30 + 50).
MANNER_SHAPES = [(1792, 66, 300, 15), (256, 82, 300, 15), (64, 80, 300, 15)]
PLM_D, PLM_H = 768, 16  # the PLM head's MHSA and NRMS's user encoder over it
# (U, L, D, heads) of the long instances (``mhsa.long_instance``): NRMS's user
# encoder at data.max_history_len=200 in a train step (batch 64) and in a
# served impression batch (512 users), the PLM head at tokenizer_max_len=256
# (512 news rows), CAUM's default head dim 100 at L = 100, two heads over 300
# (head dim 150) at L = 200, head dim 1,024 (one head) at L = 129 and head dim
# 384 (two heads over 768) at L = 256: the last two in the XL instances.
LONG_SHAPES = [(64, 200, 300, 15), (512, 200, 300, 15), (512, 256, 768, 16),
               (64, 100, 400, 4), (64, 200, 300, 2), (8, 129, 1024, 1), (64, 256, 768, 2)]


def plm_statfix_shapes(batches: int = 50) -> list:
    """(U, L, 768, 16) of the attention calls of ``nrms_statfix_plm_supconloss``'s
    train steps, read off ``TrainBatcher`` at that experiment's batch of 8,
    ``u_bucket_min`` 128 and split at 16 (``profile_train.PLM_DATA``) over the
    first ``batches`` batches of the bench workload of seed 0, as
    ``chip_smoke.main_path_shapes`` reads the serving path's: the title
    segments, largest first, then the user encoder's (8, 50)."""
    import numpy as np

    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.data.synthetic import make_serving_workload
    from newsreclib_tpu_torch.profile_train import PLM_DATA

    store, imp = make_serving_workload(np.random.default_rng(0))
    seen = set()
    for _, b in zip(range(batches), TrainBatcher(store, imp, batch_size=8, **PLM_DATA).epoch(0)):
        seen |= {tuple(seg.title.shape) for seg in (b.news, b.news2) if seg is not None}
    return ([(u, l, PLM_D, PLM_H) for u, l in sorted(seen, reverse=True)]
            + [(8, PLM_DATA["max_history_len"], PLM_D, PLM_H)])
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores, bf16 tensor cores
# float32 at f32 accuracy on the tensor cores: split TF32 runs three TF32
# products (495 TFLOP/s) for one f32 product, as the kernel's f32 instances do.
PEAK_TF32X3_FLOPS = 495e12 / 3
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


def mhsa_inputs(u, l, dtype, seed, d=D):
    """qkv ~ N(0, 1) and a prefix key mask of random length, with row 0 (the
    padding article) fully masked, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((u, l, 3 * d), generator=g, device="cuda").to(dtype)
    lens = torch.randint(1, l + 1, (u,), generator=g, device="cuda")
    mask = torch.arange(l, device="cuda")[None, :] < lens[:, None]
    mask[0] = False
    return qkv, mask.contiguous()


def bound(u, l, name, part="forward", d=D, h=H) -> tuple:
    """(least ms on the card, "bytes" or "operations") for the attention of
    (U, L, D, heads) in type ``name``: its ``"forward"``, its ``"backward"``
    alone or ``"both"`` (see module doc)."""
    es = 2 if name == "bfloat16" else 4
    qkv, ctx, mask = u * l * 3 * d * es, u * l * d * es, u * l
    product = 2 * u * h * l * l * (d // h)  # operations of one (L, L) x (L, hd) product
    nbytes, flops = {
        "forward": (qkv + mask + ctx, 2 * product),
        "backward": (qkv + mask + ctx + qkv, 5 * product),
        "both": (2 * (qkv + mask + ctx) + qkv, 6 * product),
    }[part]
    peak = PEAK_TF32X3_FLOPS if name == "tf32x3" else PEAK_FLOPS[name]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def add_bound_shares(rec: dict, parts) -> None:
    """For each ``(prefix, part)`` of ``parts`` (prefix "" / "bwd_" / "fwd_",
    part as ``bound``): ``<prefix>pct_of_bound``, the bound as a percentage
    of the measured ``<prefix>ms``; for float32 also the bound with the
    operations at split TF32's rate on the tensor cores
    (``<prefix>tf32x3_bound_ms``) and the same share of it.  The float32
    ``bound_ms`` keeps dividing by the CUDA cores' 67 TFLOP/s."""
    for prefix, part in parts:
        ms = rec.get(prefix + "ms")
        if not isinstance(ms, float) or ms <= 0:
            continue
        rec[prefix + "pct_of_bound"] = 100 * rec[prefix + "bound_ms"] / ms
        if rec["dtype"] == "float32":
            b, _ = bound(rec["U"], rec["L"], "tf32x3", part, rec["D"], rec["H"])
            rec[prefix + "tf32x3_bound_ms"] = b
            rec[prefix + "tf32x3_pct_of_bound"] = 100 * b / ms


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


def device_ms(fn, iters: int = ITERS, warmup: int = WARMUP, attempts: int = 6) -> float:
    """Device milliseconds per call of ``fn(i)``: the self time of every CUDA
    kernel it launched, from ``torch.profiler``, over ``iters`` calls.  A
    window in which the profiler recorded fewer kernels than calls (every
    call launches at least one) is profiled again, up to ``attempts``
    windows: on the H100 one window recorded none, one recorded a twentieth
    of the launches (0.0033 ms a call, under the bound), and once three
    windows in a row fell short."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        events = device_events(prof)
        us = sum(e.self_device_time_total for e in events)
        if us > 0 and sum(e.count for e in events) >= iters:
            return us / iters / 1e3
    raise RuntimeError(f"torch.profiler recorded fewer kernels than calls in {attempts} windows")


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


def raw_backward(lib: ctypes.CDLL):
    """``(qkv, mask, num_heads, grad_out) -> dqkv`` through another build's
    ``nrl_mhsa_bwd``, with the wrapper's allocation and no launch count.  A
    build with ``nrl_mhsa_bwd_workspace`` takes a workspace pointer after
    dqkv (allocated here); an older one does not."""
    fn = lib.nrl_mhsa_bwd
    workspace = getattr(lib, "nrl_mhsa_bwd_workspace", None)
    fn.argtypes = ([ctypes.c_void_p] * (4 + (workspace is not None)) + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if workspace is not None:
        workspace.argtypes, workspace.restype = [ctypes.c_int] * 5, ctypes.c_size_t
    dtypes = {torch.float32: 0, torch.bfloat16: 1}

    def launch(qkv, mask, num_heads, grad_out):
        u, l, d3 = qkv.shape
        dqkv = torch.empty_like(qkv)
        args = (u, l, d3 // 3, num_heads, dtypes[qkv.dtype])
        buf = [] if workspace is None else [
            torch.empty(workspace(*args), dtype=torch.uint8, device=qkv.device)]
        rc = fn(qkv.data_ptr(), mask.data_ptr(), grad_out.data_ptr(), dqkv.data_ptr(),
                *(b.data_ptr() for b in buf), *args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline nrl_mhsa_bwd failed: cudaError {rc}")
        return dqkv

    return launch


def baseline_takes(launch, l, d, h, dtype) -> bool:
    """Whether another build's forward (``raw_launcher``) takes (L, D,
    heads) in ``dtype``: one launch on a single zero sequence, which an
    older source refuses with cudaErrorInvalidValue (1) where its shape rule
    does not take the shape."""
    qkv = torch.zeros((1, l, 3 * d), dtype=dtype, device="cuda")
    try:
        launch(qkv, torch.ones((1, l), dtype=torch.bool, device="cuda"), h)
    except RuntimeError as e:
        if str(e).endswith("cudaError 1"):
            return False
        raise
    torch.cuda.synchronize()
    return True


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


def measure_shape(u, l, dtype, variants, library=True, unchecked=(), d=D, h=H) -> dict:
    """Check each ``(name, launch)`` of ``variants`` against ``mhsa_plain``
    at (U, L), then time them in turns (forward, then backward order), the
    plain version and the library call.  The first variant's numbers are
    ``ms`` / ``event_ms`` / ``max_abs_err``, the others' are prefixed with
    their name.  Variants named in ``unchecked`` are not held to the
    tolerance."""
    from newsreclib_tpu_torch.ops.mhsa import mhsa_plain

    name = dtype_name(dtype)
    qkv, mask = mhsa_inputs(u, l, dtype, seed=u + l, d=d)
    want = mhsa_plain(qkv, mask, h).float()
    limit = ATOL[name] + RTOL[name] * want.abs()
    rec = dict(U=u, L=l, D=d, H=h, dtype=name)
    for i, (vname, launch) in enumerate(variants):
        got = launch(qkv, mask, h)
        torch.cuda.synchronize()
        if got.shape != (u, l, d) or got.dtype != dtype:
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
        times[vname].append((device_ms(lambda i: launch(*sets[i % n], h)),
                             event_ms(lambda i: launch(*sets[i % n], h))))
    for i, (vname, _) in enumerate(variants):
        prefix = "" if i == 0 else vname + "_"
        rec[prefix + "ms"] = sum(t[0] for t in times[vname]) / len(times[vname])
        rec[prefix + "event_ms"] = sum(t[1] for t in times[vname]) / len(times[vname])
        rec[prefix + "ms_runs"] = [t[0] for t in times[vname]]
    rec["plain_ms"] = device_ms(lambda i: mhsa_plain(*sets[i % n], h))
    if library:
        calls = [sdpa_call(x, m, h) for x, m in sets]
        calls[0]()
        torch.cuda.synchronize()
        rec["library_ms"] = device_ms(lambda i: calls[i % n]())
        rec["library_backend"] = LIBRARY_BACKEND
        del calls
    rec["bound_ms"], rec["bound_by"] = bound(u, l, name, d=d, h=h)
    add_bound_shares(rec, (("", "forward"),))
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


def _fused_grad(x, mask, grad_out, h=H):
    from newsreclib_tpu_torch.ops.mhsa import FusedSmallMHSA

    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(FusedSmallMHSA.apply(x, mask, h), x, grad_out)[0]


def _plain_grad(x, mask, grad_out, h=H):
    from newsreclib_tpu_torch.ops.mhsa import mhsa_plain

    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(mhsa_plain(x, mask, h), x, grad_out)[0]


def _float64_grad(qkv, mask, grad_out, h):
    """d(sum(attention(qkv) * grad_out)) / d qkv computed in float64."""
    x = qkv.double().requires_grad_(True)
    u, l, d3 = x.shape
    d = d3 // 3
    q, k, v = (t.reshape(u, l, h, d // h).transpose(1, 2) for t in x.split(d, dim=-1))
    s = torch.where(mask[:, None, None, :], q @ k.transpose(-1, -2) / math.sqrt(d // h), -1e30)
    out = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(u, l, d)
    return torch.autograd.grad(out, x, grad_out.double())[0]


def gradient_components(u, l, dtype, baseline=None, d=D, h=H) -> dict:
    """The backward kernel's gradient at (U, L) split into dQ, dK and dV,
    held against autograd of ``mhsa_plain`` (``autograd``),
    ``mhsa_backward`` (``backward``) and a float64 reference
    (``float64``), and autograd of ``mhsa_plain`` itself against the
    float64 one (``plain_float64``), for the output gradients of
    ``check_backward`` (seeded with L) and of ``chip_smoke``'s phase 19a
    (seeded with U).  ``<ref>_<part>`` is the largest error over the
    tolerance, ATOL + RTOL |ref| (above 1 fails it); ``baseline``, another
    build's backward (``raw_backward``), gets ``baseline_<ref>_<part>``."""
    from newsreclib_tpu_torch.ops.mhsa import _backward, mhsa_backward

    name = dtype_name(dtype)
    qkv, mask = mhsa_inputs(u, l, dtype, seed=u + l, d=d)
    rec = dict(U=u, L=l, D=d, H=h, dtype=name)
    for tag, seed in (("seed_l", l), ("seed_u", u)):
        g = torch.randn((u, l, d), generator=torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda").to(dtype)
        refs = {"autograd": _plain_grad(qkv, mask, g, h), "backward": mhsa_backward(qkv, mask, h, g),
                "float64": _float64_grad(qkv, mask, g, h)}
        grads = {"": _backward(qkv, mask, h, g), "plain_": refs["autograd"]}
        if baseline is not None:
            grads["baseline_"] = baseline(qkv, mask, h, g)
        for prefix, got in grads.items():
            for ref, want in refs.items():
                if prefix == "plain_" and ref != "float64":
                    continue
                for i, part in enumerate(("dq", "dk", "dv")):
                    a = got[..., i * d:(i + 1) * d].double()
                    b = want[..., i * d:(i + 1) * d].double()
                    ratio = ((a - b).abs() / (ATOL[name] + RTOL[name] * b.abs())).max().item()
                    rec[f"{tag}_{prefix}{ref}_{part}"] = ratio
    return rec


def check_backward(u, l, dtype, backward=None, forward=None, checked=True,
                   label="FusedSmallMHSA", d=D, h=H):
    """Hold ``FusedSmallMHSA`` at (U, L) against the plain version with a
    random output gradient: its output (the forward kernel's) against
    ``mhsa_plain`` and its gradient (the backward kernel's) against autograd
    of ``mhsa_plain``, each within ATOL + RTOL * |plain|.  ``backward(qkv,
    mask, num_heads, grad_out)``, when given, stands in for the gradient (a
    planted fault, to show that the check can fail, or another build's
    kernel), and ``forward(qkv, mask, num_heads)`` for the output; with
    ``checked`` false the errors are only measured.  Returns ``(max abs
    output err, max abs gradient err, (qkv, mask, grad_out))``."""
    from newsreclib_tpu_torch.ops.mhsa import FusedSmallMHSA, mhsa_plain

    name = dtype_name(dtype)
    qkv, mask = mhsa_inputs(u, l, dtype, seed=u + l, d=d)
    g = torch.randn((u, l, d), generator=torch.Generator(device="cuda").manual_seed(l),
                    device="cuda").to(dtype)
    x = qkv.detach().requires_grad_(True)
    out = FusedSmallMHSA.apply(x, mask, h) if forward is None else forward(qkv, mask, h)
    got = torch.autograd.grad(out, x, g)[0] if backward is None else backward(qkv, mask, h, g)
    want = _plain_grad(qkv, mask, g, h).float()
    want_out = mhsa_plain(qkv, mask, h).float()
    torch.cuda.synchronize()
    errs = []
    for what, a, b in (("output", out.detach().float(), want_out), ("gradient", got.float(), want)):
        err = (a - b).abs()
        if checked and (not bool(torch.isfinite(a).all()) or not bool(
                (err <= ATOL[name] + RTOL[name] * b.abs()).all())):
            raise AssertionError(f"{label} {what} != plain at U={u} L={l} {name}: "
                                 f"max abs err {err.max().item()}")
        errs.append(err.max().item())
    return errs[0], errs[1], (qkv, mask, g)


def _in_turns(fns: dict, order) -> dict:
    """Device ms of each ``fns[name](i)`` in the given order of turns:
    ``{name: [ms of each turn]}``."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(device_ms(fns[name]))
    return times


def _record_turns(rec: dict, key: str, times: list) -> None:
    rec[key], rec[key + "_runs"] = sum(times) / len(times), times


def measure_backward(u, l, dtype, baseline=None, unchecked=False, d=D, h=H) -> dict:
    """Forward + backward, the backward alone and the forward alone at
    (U, L): ``check_backward``, then the times of the module doc.
    ``baseline``, when given, is another build's ``(forward, backward)``
    launchers (``raw_launcher``, ``raw_backward``), checked the same way
    (unless ``unchecked``) and timed in turns with the kernels."""
    from newsreclib_tpu_torch.ops.mhsa import _backward, _forward, mhsa_backward, mhsa_plain

    fwd_err, err, (qkv, mask, g) = check_backward(u, l, dtype, d=d, h=h)
    rec = dict(U=u, L=l, D=d, H=h, dtype=dtype_name(dtype), max_abs_err=err,
               fwd_max_abs_err=fwd_err)
    if baseline is not None:
        b_fwd, b_bwd = baseline
        rec["baseline_fwd_max_abs_err"], rec["baseline_max_abs_err"], _ = check_backward(
            u, l, dtype, backward=b_bwd, forward=b_fwd, checked=not unchecked, label="baseline",
            d=d, h=h)
    sets = _rotated(qkv, mask, (g,))
    n = len(sets)

    def args(i):  # (qkv, mask, num_heads, grad_out) of the i-th rotated set
        x, m, go = sets[i % n]
        return x, m, h, go

    both = {"kernel": lambda i: _fused_grad(*sets[i % n], h)}
    backward = {"kernel": lambda i: _backward(*args(i)),
                "plain": lambda i: mhsa_backward(*args(i))}
    forward = {"kernel": lambda i: _forward(*args(i)[:3])}
    pair, bwd_order = ("kernel", "kernel"), ("kernel", "plain", "plain", "kernel")
    if baseline is not None:
        both["baseline"] = lambda i: (b_fwd(*args(i)[:3]), b_bwd(*args(i)))
        backward["baseline"] = lambda i: b_bwd(*args(i))
        forward["baseline"] = lambda i: b_fwd(*args(i)[:3])
        pair = ("kernel", "baseline", "baseline", "kernel")
        bwd_order = ("kernel", "baseline", "plain", "plain", "baseline", "kernel")
    for fns, order, suffix in ((both, pair, "ms"), (backward, bwd_order, "bwd_ms"),
                               (forward, pair, "fwd_ms")):
        for name, times in _in_turns(fns, order).items():
            _record_turns(rec, suffix if name == "kernel" else f"{name}_{suffix}", times)
    rec["event_ms"] = event_ms(both["kernel"])
    rec["bwd_event_ms"] = event_ms(backward["kernel"])
    rec["plain_fwd_ms"] = device_ms(lambda i: mhsa_plain(*args(i)[:3]))

    rec["plain_ms"] = device_ms(lambda i: _plain_grad(*sets[i % n], h))
    calls = [sdpa_call(x, m, h) for x, m, _ in sets]
    calls[0]()
    torch.cuda.synchronize()
    rec["library_fwd_ms"] = device_ms(lambda i: calls[i % n]())
    del calls
    for key, only in (("library_ms", False), ("library_bwd_ms", True)):
        calls = [sdpa_grad_call(x, m, h, go, backward_only=only) for x, m, go in sets]
        calls[0]()
        torch.cuda.synchronize()
        rec[key] = device_ms(lambda i: calls[i % n]())
        del calls
    rec["library_backend"] = LIBRARY_BACKEND
    rec["bound_ms"], rec["bound_by"] = bound(u, l, rec["dtype"], "both", d, h)
    rec["bwd_bound_ms"], rec["bwd_bound_by"] = bound(u, l, rec["dtype"], "backward", d, h)
    rec["fwd_bound_ms"], rec["fwd_bound_by"] = bound(u, l, rec["dtype"], "forward", d, h)
    add_bound_shares(rec, (("", "both"), ("bwd_", "backward"), ("fwd_", "forward")))
    rec["rotated_sets"] = n
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="another version of csrc/mhsa.cu to time against")
    ap.add_argument("--unchecked", action="store_true",
                    help="do not hold the baseline to the tolerance (diagnostic builds)")
    ap.add_argument("--backward", action="store_true",
                    help="time forward + backward at the train step's shapes")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="only this type (default: both)")
    ap.add_argument("--shapes", choices=("all", "manner", "plm_statfix", "long", "narrow"),
                    default="all",
                    help="manner: MANNER_SHAPES alone; plm_statfix: plm_statfix_shapes(); "
                         "long: LONG_SHAPES; narrow: NARROW_BWD_SHAPES with --backward, the "
                         "serving, extra and rank shapes without")
    ap.add_argument("--only", action="append", metavar="U,L,D,H",
                    help="time these shapes (repeatable) in place of the --shapes list")
    ap.add_argument("--components", action="store_true",
                    help="the backward's dQ, dK and dV against the plain versions and float64 "
                         "(gradient_components), no timing")
    ap.add_argument("--json", type=Path, help="also write the records here, one per line")
    args = ap.parse_args(argv)
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
    baseline = None
    if args.baseline is not None:
        lib = build.load_source(args.baseline)
        baseline = (raw_launcher(lib), raw_backward(lib))
        variants.append(("baseline", baseline[0]))
    records = []
    dtypes = (torch.bfloat16, torch.float32)
    for dtype in dtypes if args.dtype is None else (getattr(torch, args.dtype),):
        nrms = NARROW_BWD_SHAPES if args.backward else SERVING_SHAPES + EXTRA_SHAPES + RANK_SHAPES
        shapes = {"all": lambda: [(u, l, D, H) for u, l in nrms] + ZOO_SHAPES + PLM_SHAPES
                  + MANNER_SHAPES, "manner": lambda: MANNER_SHAPES,
                  "plm_statfix": plm_statfix_shapes, "long": lambda: LONG_SHAPES,
                  "narrow": lambda: [(u, l, D, H) for u, l in nrms]}[args.shapes]()
        if args.only:
            shapes = [tuple(int(x) for x in o.split(",")) for o in args.only]
        for u, l, d, h in shapes:
            # an older source may refuse a shape: its row says so
            takes = baseline is not None and baseline_takes(baseline[0], l, d, h, dtype)
            if args.components:
                rec = gradient_components(u, l, dtype, baseline[1] if takes else None, d=d, h=h)
            elif args.backward:
                rec = measure_backward(u, l, dtype, baseline if takes else None,
                                       unchecked=args.unchecked, d=d, h=h)
            else:
                rec = measure_shape(u, l, dtype, variants if takes else variants[:1], d=d, h=h,
                                    unchecked=("baseline",) if args.unchecked else ())
            if baseline is not None and not takes and not args.components:
                for key in (("baseline_ms", "baseline_bwd_ms", "baseline_fwd_ms")
                            if args.backward else ("baseline_ms",)):
                    rec[key] = "refused"
            rec["card"] = card
            print("kernel_bench " + json.dumps(rec), flush=True)
            records.append(rec)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text("".join(json.dumps(r) + "\n" for r in records))
    if args.components:
        print(f"card: {card}")
        return 0
    cols = ["U", "L", "D", "H", "dtype", "ms", "bound_ms", "pct_of_bound", "plain_ms",
            "library_ms", "event_ms", "max_abs_err"]
    cols[4:4] = (["bwd_ms", "baseline_bwd_ms", "bwd_bound_ms", "bwd_pct_of_bound",
                  "plain_bwd_ms", "library_bwd_ms", "fwd_ms", "baseline_fwd_ms", "fwd_bound_ms",
                  "fwd_pct_of_bound", "library_fwd_ms", "baseline_ms"]
                 if args.backward else ["baseline_ms"])
    print(" | ".join(cols))
    for r in records:
        print(" | ".join(str(r.get(c, "")) for c in cols))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
