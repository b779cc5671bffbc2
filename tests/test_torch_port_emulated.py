"""The CUDA kernels of ``csrc/mhsa.cu`` on the CPU, through an emulation of
the card (``tests/cuda_emu``): the source is translated to C++
(``translate.py``: each ``asm`` statement becomes the operation it performs,
each launch a call of the emulator) and built with g++ against
``include/emu.h``, which runs one thread per CUDA thread and computes the
warp collectives (``mma.sync``, ``ldmatrix``, ``movmatrix``, shuffles) from
the PTX fragment layouts.  So the kernels' own indexing, fragment layouts,
staging, padding and masking run here, as the card runs them, at small
shapes: forward and backward against ``mhsa_plain`` / ``mhsa_backward``
(whose agreement with the JAX package ``test_torch_port_ops.py`` and
``test_torch_port_contract.py`` hold), the narrow instances, the wide ones
and the long ones (L above 128, head dims beyond the box, up to 1,024); and
the source's shape rule (``check_args``, ``instance_smem``,
``wide_instance``, ``long_instance``, the backward's workspace) against the
wrapper's (``kernel_supports``, ``smem_bytes``, ``wide_instance``,
``long_instance``), which must agree.

What the emulation does not show: the tensor cores' own rounding (it sums
products in f32 in k order), timing, registers and spills, and what nvcc
refuses.  Those are the card's (``test_torch_port_gpu.py``).

Tolerances: float32 atol/rtol 1e-5 (split TF32 against float32 sums in
another order); bfloat16 atol 2e-2 / rtol 1e-2 (p and dS rounded to bf16 as
operands, the result rounded once), as on the card.
"""

import ctypes
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

from newsreclib_tpu_torch.ops import mhsa

ROOT = Path(__file__).resolve().parent.parent
EMU = Path(__file__).resolve().parent / "cuda_emu"
SOURCE = ROOT / "newsreclib_tpu_torch" / "csrc" / "mhsa.cu"
OUT = ROOT / "build" / "emu"
GXX_FLAGS = ["-std=c++20", "-O1", "-fPIC", "-shared", "-pthread"]
# The source's shape rule, exported from the translation unit for the test.
RULE = """
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
"""
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CALL_TIMEOUT_S = 300


def _run(fn, *args) -> int:
    """``fn(*args)`` on a daemon thread, failing the test after
    CALL_TIMEOUT_S: lanes that diverge at a warp collective leave the
    emulator's barriers waiting for ever, which must not hang the suite."""
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
    if not target.exists():
        OUT.mkdir(parents=True, exist_ok=True)
        cpp = target.with_suffix(f".{os.getpid()}.cpp")
        tmp = target.with_suffix(f".so.tmp{os.getpid()}")
        cpp.write_text(src)
        cmd = [gxx, *GXX_FLAGS, "-I", str(EMU / "include"), "-include", "emu.h", "-x", "c++",
               str(cpp), "-o", str(tmp)]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        cpp.unlink()
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed on the translated csrc/mhsa.cu:\n{done.stderr}")
        os.replace(tmp, target)
    so = ctypes.CDLL(str(target))
    so.nrl_mhsa_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    so.nrl_mhsa_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    so.nrl_mhsa_bwd_workspace.argtypes = [ctypes.c_int] * 5
    so.nrl_mhsa_bwd_workspace.restype = ctypes.c_size_t
    so.nrl_emu_instance_smem.restype = ctypes.c_long
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
# head dims 20 (NRMS's user encoder at history 200), 48 (the PLM head) and
# 65 (odd); head dims 100 (L = 129), 150 (L = 70) and 256 (L = 129), with
# storage offsets; head dims 300 and 1,024 (the tiles of 16 and 8 rows) at
# short L.
LONG_SHAPES = [(2, 129, 60, 3, 0), (2, 200, 96, 2, 1), (2, 257, 65, 1, 0), (2, 129, 200, 2, 1),
               (2, 70, 300, 2, 1), (2, 129, 256, 1, 0), (2, 20, 600, 2, 0), (2, 9, 1024, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l,d,h,shift", SHAPES + LONG_SHAPES)
def test_emulated_kernels_match_plain(lib, u, l, d, h, shift, dtype):
    assert bool(lib.nrl_emu_long_instance(l, d, h)) == ((u, l, d, h, shift) in LONG_SHAPES)
    qkv, mask, grad_out = _inputs(u, l, d, dtype, seed=u * l + d, shift=shift)
    out = torch.empty((u, l, d), dtype=dtype)
    assert _run(lib.nrl_mhsa_fwd, qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), u, l, d, h,
                DTYPES[dtype], None) == 0
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), mhsa.mhsa_plain(qkv, mask, h).float(), **TOL[dtype])
    # the fully masked sequence: the uniform mean of v over its L keys
    torch.testing.assert_close(out[0].float(),
                               qkv[0, :, 2 * d:].float().mean(dim=0).expand(l, d), **TOL[dtype])
    dqkv = torch.empty((u, l, 3 * d), dtype=dtype)
    workspace = torch.empty(lib.nrl_mhsa_bwd_workspace(u, l, d, h, DTYPES[dtype]),
                            dtype=torch.uint8)
    assert _run(lib.nrl_mhsa_bwd, qkv.data_ptr(), mask.data_ptr(), grad_out.data_ptr(),
                dqkv.data_ptr(), workspace.data_ptr(), u, l, d, h, DTYPES[dtype], None) == 0
    assert torch.isfinite(dqkv).all()
    torch.testing.assert_close(dqkv.float(),
                               mhsa.mhsa_backward(qkv, mask, h, grad_out).float(), **TOL[dtype])
    # the fully masked sequence: no gradient on q and k
    assert bool((dqkv[0, :, :2 * d] == 0).all())


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
