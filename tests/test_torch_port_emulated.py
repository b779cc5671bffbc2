"""The CUDA kernels of ``csrc/mhsa.cu`` on the CPU, through an emulation of
the card (``tests/cuda_emu``): the source is translated to C++
(``translate.py``: each ``asm`` statement becomes the operation it performs,
each launch a call of the emulator) and built with g++ against
``include/emu.h``, which runs a block's CUDA threads as cooperative fibers
on one OS thread and computes the warp collectives (``mma.sync``,
``ldmatrix``, ``movmatrix``, shuffles) from the PTX fragment layouts.  So
the kernels' own indexing, fragment layouts, staging, padding and masking
run here, as the card runs them, at small shapes: forward and backward
against ``mhsa_plain`` / ``mhsa_backward`` (whose agreement with the JAX
package ``test_torch_port_ops.py`` and ``test_torch_port_contract.py``
hold), the narrow instances, the wide ones and the long ones (L above 128,
head dims beyond the box, up to 1,024: the tensor-core instances up to head
dim 256, across masked key tiles, and the XL ones above, whose warps split
the head dim; the narrow bf16 backward's persistent blocks in both grid
modes); the emulator's
own stop of a barrier that cannot complete; and the source's shape rule
(``check_args``, ``instance_smem``, ``wide_instance``, ``long_instance``,
the backward's workspace) against the wrapper's (``kernel_supports``,
``smem_bytes``, ``wide_instance``, ``long_instance``), which must agree.

What the emulation does not show: the tensor cores' own rounding (it sums
products in f32 in k order), timing, registers and spills, and what nvcc
refuses.  Those are the card's (``test_torch_port_gpu.py``).

Tolerances: float32 atol/rtol 1e-5 (split TF32 against float32 sums in
another order); bfloat16 atol 2e-2 / rtol 1e-2 (p and dS rounded to bf16 as
operands, the result rounded once), as on the card.
"""

import ctypes
import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from newsreclib_tpu_torch.ops import build, mhsa

ROOT = Path(__file__).resolve().parent.parent
EMU = Path(__file__).resolve().parent / "cuda_emu"
SOURCE = ROOT / "newsreclib_tpu_torch" / "csrc" / "mhsa.cu"
OUT = ROOT / "build" / "emu"
GXX_FLAGS = ["-std=c++20", "-O1", "-fPIC", "-pthread"]
PARTS = build.PARTS["mhsa"]
# The source's shape rule, exported from the translation unit (its part 1)
# for the test.
RULE = """
#if NRL_BUILDS(1)
extern "C" int nrl_emu_check_args(int U, int L, int D, int H, int dtype) {
  return check_args(U, L, D, H, dtype);
}
extern "C" long nrl_emu_instance_smem(int L, int D, int H, int es) {
  return (long)instance_smem(L, D, H, es);
}
extern "C" int nrl_emu_wide_instance(int L, int D, int H, int es) {
  return wide_instance(L, D, H, es);
}
extern "C" int nrl_emu_long_instance(int L, int D, int H) {
  return long_instance(L, D, H);
}
extern "C" void nrl_emu_bwd_plan(int U, int L, int D, int H, int* out) {
  const BwdPlan p = bwd_plan(U, L, D, H, 132);
  out[0] = p.S;
  out[1] = p.HG;
  out[2] = p.W;
  out[3] = p.grid;
}
#endif
"""
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CALL_TIMEOUT_S = 300


def _run(fn, *args) -> int:
    """``fn(*args)`` on a daemon thread, failing the test after
    CALL_TIMEOUT_S: the emulator stops a barrier that can never complete at
    once, but a kernel that loops for ever must not hang the suite either."""
    result = []
    worker = threading.Thread(target=lambda: result.append(fn(*args)), daemon=True)
    worker.start()
    worker.join(CALL_TIMEOUT_S)
    if worker.is_alive():
        pytest.fail(f"the emulated {fn.__name__} did not return in {CALL_TIMEOUT_S} s")
    return result[0]


def _translate(text: str) -> str:
    spec = importlib.util.spec_from_file_location("cuda_emu_translate", EMU / "translate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.translate(text)


def _build(gxx, src, target):
    """g++ on the translated source in the parts of the card's build
    (``NRL_PART``, all compiled at once), then one link."""
    cpp = target.with_suffix(f".{os.getpid()}.cpp")
    tmp = target.with_suffix(f".so.tmp{os.getpid()}")
    objects = [target.with_suffix(f".part{k}.{os.getpid()}.o") for k in range(1, PARTS + 1)]
    cpp.write_text(src)
    try:
        procs = [subprocess.Popen([gxx, *GXX_FLAGS, "-c", f"-DNRL_PART={k}", "-I",
                                   str(EMU / "include"), "-include", "emu.h", "-x", "c++",
                                   str(cpp), "-o", str(obj)],
                                  stderr=subprocess.PIPE, text=True)
                 for k, obj in enumerate(objects, start=1)]
        errors = [err for proc in procs if (err := proc.communicate(timeout=600)[1])
                  and proc.returncode != 0]
        if not errors:
            link = subprocess.run([gxx, *GXX_FLAGS, "-shared", *map(str, objects), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=600)
            errors = [link.stderr] if link.returncode != 0 else []
        if errors:
            raise RuntimeError("g++ failed on the translated csrc/mhsa.cu:\n" + "\n".join(errors))
        os.replace(tmp, target)
    finally:
        cpp.unlink()
        for obj in objects:
            obj.unlink(missing_ok=True)


@pytest.fixture(scope="module")
def lib():
    """The emulated build of ``csrc/mhsa.cu``, under ``build/emu/`` keyed by
    the translated source, the emulator and the flags."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the CPU emulation of the CUDA kernels")
    src = _translate(SOURCE.read_text()) + RULE
    key = src + (EMU / "include" / "emu.h").read_text() + " ".join(GXX_FLAGS)
    target = OUT / f"libmhsa_emu-{hashlib.sha1(key.encode()).hexdigest()[:12]}.so"
    OUT.mkdir(parents=True, exist_ok=True)
    with open(target.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one worker builds, the others wait for it
        if not target.exists():
            _build(gxx, src, target)
    so = ctypes.CDLL(str(target))
    so.nrl_mhsa_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    so.nrl_mhsa_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    so.nrl_mhsa_bwd_workspace.argtypes = [ctypes.c_int] * 5
    so.nrl_mhsa_bwd_workspace.restype = ctypes.c_size_t
    so.nrl_emu_instance_smem.restype = ctypes.c_long
    so.nrl_emu_bwd_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return so


def _inputs(u, l, d, dtype, seed, shift):
    """qkv, a key mask and an output gradient, qkv and dO starting ``shift``
    elements into their storage: sequence 0 fully masked, the others random
    with their first key valid."""
    rng = np.random.default_rng(seed)

    def placed(shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
        buf = torch.zeros(x.numel() + shift, dtype=dtype)
        out = buf[shift:].view(shape)
        out.copy_(x)
        return out

    qkv, grad_out = placed((u, l, 3 * d)), placed((u, l, d))
    mask = rng.random((u, l)) < 0.6
    mask[:, 0] = True
    mask[0] = False
    return qkv, torch.from_numpy(mask), grad_out


# (U, L, D, heads, storage offset): the hd <= 32 instances (hd 20, the NRMS
# instances, and hd 16), then the wide ones: MINS's head dim 50, the PLM
# head's 48 at L = 96, L = 128, L = 65, head dims 100 and 128, head dim 55
# off a 4-byte boundary, and a bf16 slab too large for one block (which
# float32 runs in its hd <= 32 instance).
SHAPES = [(3, 16, 60, 3, 0), (3, 30, 96, 6, 0), (2, 50, 100, 2, 0), (2, 96, 96, 2, 0),
          (2, 128, 32, 2, 0), (2, 65, 40, 2, 0), (2, 50, 200, 2, 0), (1, 64, 256, 2, 0),
          (2, 49, 110, 2, 1), (1, 64, 640, 20, 0)]
# The long instances: L = 129, 200 and 257 (the last key tile partial) at
# head dims 20 (NRMS's user encoder at history 200, zero-padded to the mma
# k-step), 48 (the PLM head) and 65 (odd); head dims 100 (L = 129), 150 (L =
# 70; float32 in 32-row tiles) and 256 (L = 129), in column groups of 64,
# with storage offsets; head dim 130 in one partial tile; head dims 255 and
# 257, just below and above the tensor-core instances' bound (256); head
# dims 300 and 1,024 (the XL instances: 5 and 16 warps splitting the head
# dim) at short L.
LONG_SHAPES = [(2, 129, 60, 3, 0), (2, 200, 96, 2, 1), (2, 257, 65, 1, 0), (2, 129, 200, 2, 1),
               (2, 70, 300, 2, 1), (2, 129, 256, 1, 0), (2, 20, 600, 2, 0), (2, 9, 1024, 1, 1),
               (2, 40, 260, 2, 0), (2, 100, 255, 1, 1), (2, 70, 514, 2, 0)]


def _check(lib, qkv, mask, grad_out, h, dtype):
    """Both entry points on the emulated card against ``mhsa_plain`` and
    ``mhsa_backward``; a fully masked sequence gets the uniform mean of v
    over its L keys and no gradient on q and k."""
    u, l, d3 = qkv.shape
    d = d3 // 3
    out = torch.empty((u, l, d), dtype=dtype)
    assert _run(lib.nrl_mhsa_fwd, qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), u, l, d, h,
                DTYPES[dtype], None) == 0
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), mhsa.mhsa_plain(qkv, mask, h).float(), **TOL[dtype])
    dqkv = torch.empty((u, l, 3 * d), dtype=dtype)
    workspace = torch.empty(lib.nrl_mhsa_bwd_workspace(u, l, d, h, DTYPES[dtype]),
                            dtype=torch.uint8)
    assert _run(lib.nrl_mhsa_bwd, qkv.data_ptr(), mask.data_ptr(), grad_out.data_ptr(),
                dqkv.data_ptr(), workspace.data_ptr(), u, l, d, h, DTYPES[dtype], None) == 0
    assert torch.isfinite(dqkv).all()
    torch.testing.assert_close(dqkv.float(),
                               mhsa.mhsa_backward(qkv, mask, h, grad_out).float(), **TOL[dtype])
    for s in (~mask.any(dim=1)).nonzero().flatten().tolist():
        torch.testing.assert_close(out[s].float(),
                                   qkv[s, :, 2 * d:].float().mean(dim=0).expand(l, d),
                                   **TOL[dtype])
        assert bool((dqkv[s, :, :2 * d] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l,d,h,shift", SHAPES + LONG_SHAPES)
def test_emulated_kernels_match_plain(lib, u, l, d, h, shift, dtype):
    assert bool(lib.nrl_emu_long_instance(l, d, h)) == ((u, l, d, h, shift) in LONG_SHAPES)
    qkv, mask, grad_out = _inputs(u, l, d, dtype, seed=u * l + d, shift=shift)
    assert not bool(mask[0].any())
    _check(lib, qkv, mask, grad_out, h, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l,d,h", [(3, 200, 60, 3), (3, 150, 96, 2)])
def test_emulated_long_kernels_across_masked_tiles(lib, u, l, d, h, dtype):
    """The long instances' online softmax across key tiles of 64: in every
    sequence keys 64-127 (a whole tile) are masked between valid ones; in
    sequence 1 the first two tiles and more (keys 0-139) are masked, so its
    running state starts from masked keys (max -1e30) and must drop them at
    the first valid key; sequence 2 is fully masked."""
    qkv, mask, grad_out = _inputs(u, l, d, dtype, seed=l + d, shift=0)
    mask[:] = torch.rand((u, l), generator=torch.Generator().manual_seed(l)) < 0.6
    mask[:, 64:128] = False
    mask[1, :140] = False
    mask[2] = False
    assert bool(mask[0, :64].any() and mask[0, 128:].any() and mask[1, 140:].any())
    _check(lib, qkv, mask, grad_out, h, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l,d,h", [(3, 40, 300, 1), (3, 37, 1200, 2), (3, 33, 1024, 1)])
def test_emulated_xl_kernels_across_masked_tiles(lib, u, l, d, h, dtype):
    """The XL instances (head dims 300, 600 and 1,024: a block's warps split
    the head dim, the logits of each tile pair summed over them) across
    masked streamed tiles (16 keys in bf16, 8 in float32): in every
    sequence keys 16-31 are masked between valid ones; in sequence 1 keys
    0-23 too, so its running state starts from masked keys and must drop
    them at the first valid key; sequence 2 is fully masked."""
    assert mhsa.long_instance(l, d, h) and not mhsa.long_tc(d // h, dtype)
    qkv, mask, grad_out = _inputs(u, l, d, dtype, seed=l + d, shift=0)
    mask[:] = torch.rand((u, l), generator=torch.Generator().manual_seed(d)) < 0.6
    mask[:, 16:32] = False
    mask[1, :24] = False
    mask[2] = False
    assert bool(mask[0, :16].any() and mask[0, 32:].any() and mask[1, 32:].any())
    _check(lib, qkv, mask, grad_out, h, dtype)


# The narrow bf16 backward (hd <= 32, L <= 64) in both of its grid modes
# (``narrow_bwd_plan``), at L = 1, 9, 16, 30 and 50: (U, L, D, heads, whole
# sequences?, several groups a block?).  At U = 3 a sequence's 15 heads
# split into groups of 8 + 7 (NRMS's widths); at U = 200 and L = 16 the
# same groups outnumber the persistent grid's blocks, which walk them
# through their ring; above the threshold whole sequences, four to a group
# (3 heads of 8, to keep the emulation short), outnumber them too.
NARROW_BWD_SHAPES = [(3, 1, 300, 15, False, False), (1100, 1, 24, 3, True, True),
                     (3, 9, 300, 15, False, False), (1100, 9, 24, 3, True, True),
                     (3, 16, 300, 15, False, False), (200, 16, 300, 15, False, True),
                     (1100, 16, 24, 3, True, True), (3, 30, 300, 15, False, False),
                     (540, 30, 24, 3, True, True), (3, 50, 300, 15, False, False),
                     (540, 50, 24, 3, True, True)]


def _plan(lib, u, l, d, h):
    out = (ctypes.c_int * 4)()
    lib.nrl_emu_bwd_plan(u, l, d, h, out)
    return tuple(out)


@pytest.mark.parametrize("u,l,d,h,whole,ring", NARROW_BWD_SHAPES)
def test_emulated_narrow_bf16_backward_in_both_grid_modes(lib, u, l, d, h, whole, ring):
    """The narrow bf16 backward's persistent blocks, whole sequences or head
    groups through the two-stage ring, against ``mhsa_backward`` (with the
    forward against ``mhsa_plain``); sequence 0 is fully masked.  The grid
    mode is the wrapper's rule (``narrow_bwd_plan``), and the source's."""
    plan = mhsa.narrow_bwd_plan(u, l, d, h)
    assert _plan(lib, u, l, d, h) == plan
    sequences, heads, _, blocks = plan
    assert (heads == h) == whole, plan
    groups = -(-u // sequences) if whole else u * -(-h // heads)
    assert (groups > blocks) == ring, plan
    assert not mhsa.wide_instance(l, d, h, torch.bfloat16) and not mhsa.long_instance(l, d, h)
    qkv, mask, grad_out = _inputs(u, l, d, torch.bfloat16, seed=u + l + d, shift=0)
    assert not bool(mask[0].any())
    _check(lib, qkv, mask, grad_out, h, torch.bfloat16)


def test_source_and_wrapper_state_the_same_backward_plan(lib):
    """``bwd_plan`` of the source against ``narrow_bwd_plan`` of the
    wrapper over U, L and head counts around the split's bounds."""
    for u in (1, 3, 32, 64, 131, 132, 133, 256, 263, 264, 265, 1024, 1056, 4096):
        for l in (1, 16, 17, 30, 32, 33, 50, 64):
            for d, h in ((300, 15), (20, 1), (60, 3), (256, 8), (96, 6), (400, 20)):
                if d // h <= 32 and not mhsa.wide_instance(l, d, h, torch.bfloat16):
                    assert _plan(lib, u, l, d, h) == mhsa.narrow_bwd_plan(u, l, d, h), (u, l, d, h)


HEAD_DIMS = (1, 7, 16, 20, 30, 32, 33, 48, 50, 63, 64, 65, 100, 127, 128, 129, 150, 256, 257,
             512, 513, 1000, 1024, 1025)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [(1, 40), (40, 80), (80, 131), (131, 301)])
def test_source_and_wrapper_state_the_same_shape_rule(lib, lengths, dtype):
    """``check_args`` / ``instance_smem`` / ``wide_instance`` /
    ``long_instance`` of the source against ``kernel_supports`` /
    ``smem_bytes`` / ``wide_instance`` / ``long_instance`` of the wrapper,
    over L in ``lengths`` (up to 300) and head dims and head counts around
    every bound (32, 64, 128, the long tiles' 64, 256 and 512, and 1,024);
    every L and every head dim up to 1,024 is taken, and the backward's
    workspace is U H L x 3 floats exactly where the long instances run."""
    es = 4 if dtype == torch.float32 else 2
    for l in range(*lengths):
        for hd in HEAD_DIMS:
            for h in (1, 2, 6, 32):
                d = hd * h
                ok = lib.nrl_emu_check_args(1, l, d, h, DTYPES[dtype]) == 0
                assert ok == mhsa.kernel_supports(l, d, h, dtype) == (hd <= 1024), (l, d, h)
                assert lib.nrl_emu_instance_smem(l, d, h, es) == mhsa.smem_bytes(l, d, h, dtype)
                assert bool(lib.nrl_emu_wide_instance(l, d, h, es)) == mhsa.wide_instance(
                    l, d, h, dtype), (l, d, h)
                long = mhsa.long_instance(l, d, h)
                assert bool(lib.nrl_emu_long_instance(l, d, h)) == long, (l, d, h)
                assert lib.nrl_mhsa_bwd_workspace(3, l, d, h, DTYPES[dtype]) == (
                    3 * h * l * 12 if ok and long else 0), (l, d, h)


@pytest.mark.parametrize("l,d,h,dtype", [(129, 1025, 1, 0), (1, 2048, 1, 1), (64, 300, 7, 0),
                                         (200, 300, 15, 2), (0, 64, 1, 0)])
def test_source_refuses_outside_the_box(lib, l, d, h, dtype):
    """What the kernels still refuse: head dims above 1,024, heads that do
    not divide D, a type code other than float32 (0) and bfloat16 (1), such
    as float16, and L = 0.  Both entry points return cudaErrorInvalidValue
    (1) before any launch, and the backward asks for no workspace."""
    lq = max(l, 1)
    qkv = torch.zeros((1, lq, 3 * d))
    mask = torch.ones((1, lq), dtype=torch.bool)
    out = torch.empty((1, lq, 3 * d))
    assert lib.nrl_mhsa_fwd(qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), 1, l, d, h, dtype,
                            None) == 1
    assert lib.nrl_mhsa_bwd_workspace(1, l, d, h, dtype) == 0
    assert lib.nrl_mhsa_bwd(qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), out.data_ptr(),
                            out.data_ptr(), 1, l, d, h, dtype, None) == 1


# Kernels that break the rules of warp collectives and barriers, each
# launched through the emulator by an entry point that returns
# cudaGetLastError().
FAULTS = r"""
__global__ void exits_before_shuffle(float* out) {
  if (threadIdx.x == 37) return;
  out[threadIdx.x] = __shfl_sync(0xffffffffu, 1.f, 0);
}
__global__ void diverged_collective(float* out) {
  if (threadIdx.x & 16) __syncwarp();
  else out[threadIdx.x] = __shfl_sync(0xffffffffu, 1.f, 0);
}
__global__ void block_barrier_against_warp(float* out) {
  if (threadIdx.x == 70) out[0] = __shfl_sync(0xffffffffu, 1.f, 0);
  else __syncthreads();
}
__global__ void well_formed(float* out) {
  __syncthreads();
  out[threadIdx.x] = __shfl_sync(0xffffffffu, (float)threadIdx.x, 3);
}
extern "C" int run_exits_before_shuffle(float* out) {
  exits_before_shuffle<<<2, 96, 0, nullptr>>>(out);
  return cudaGetLastError();
}
extern "C" int run_diverged_collective(float* out) {
  diverged_collective<<<2, 96, 0, nullptr>>>(out);
  return cudaGetLastError();
}
extern "C" int run_block_barrier_against_warp(float* out) {
  block_barrier_against_warp<<<2, 96, 0, nullptr>>>(out);
  return cudaGetLastError();
}
extern "C" int run_well_formed(float* out) {
  well_formed<<<2, 96, 0, nullptr>>>(out);
  return cudaGetLastError();
}
"""


@pytest.fixture(scope="module")
def faults(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the CPU emulation of the CUDA kernels")
    d = tmp_path_factory.mktemp("emu_faults")
    (d / "faults.cpp").write_text(_translate(FAULTS))
    done = subprocess.run([gxx, *GXX_FLAGS, "-shared", "-I", str(EMU / "include"), "-include",
                           "emu.h", "-x", "c++", str(d / "faults.cpp"), "-o", str(d / "faults.so")],
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    so = ctypes.CDLL(str(d / "faults.so"))
    for name in ("exits_before_shuffle", "diverged_collective", "block_barrier_against_warp",
                 "well_formed"):
        getattr(so, f"run_{name}").argtypes = [ctypes.c_void_p]
    return so


@pytest.mark.parametrize("name,message", [
    ("exits_before_shuffle", "block 0: the __shfl_sync of warp 1 can never complete: warp 1 "
                             "lane 0 waits at it while warp 1 lane 5 has exited"),
    ("diverged_collective", "warp 0 lane 16 reaches __syncwarp where the other lanes of its "
                            "warp wait at __shfl_sync"),
    ("block_barrier_against_warp", "the __syncthreads of the block can never complete: warp 0 "
                                   "lane 0 waits at it while warp 2 lane 6 waits at __shfl_sync"),
])
def test_emulator_stops_a_launch_whose_barrier_cannot_complete(faults, capfd, name, message):
    """A warp collective or block barrier that can never complete stops the
    launch at once (no hang to wait out), names the block, warp and lane,
    and the launch reports cudaErrorLaunchFailure (719); the next launch
    runs normally."""
    out = np.zeros(96, dtype=np.float32)
    assert _run(getattr(faults, f"run_{name}"), out.ctypes.data) == 719
    assert message in capfd.readouterr().err
    assert _run(faults.run_well_formed, out.ctypes.data) == 0
    np.testing.assert_array_equal(out, np.arange(96) // 32 * 32 + 3)
