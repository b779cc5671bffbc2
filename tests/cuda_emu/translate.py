"""Rewrite a CUDA source of the port (``csrc/*.cu``) as C++ for the CPU
emulation of ``include/emu.h``: each inline ``asm`` statement becomes the
emulated operation it performs, the dynamic shared memory a pointer to the
block's buffer, and each ``kernel<<<grid, block, smem, stream>>>(...)``
launch a call of ``emu::launch``.  An ``asm`` statement this does not know
stops the translation.

    python3 tests/cuda_emu/translate.py newsreclib_tpu_torch/csrc/mhsa.cu > mhsa_emu.cpp
"""

import re
import sys

# A distinctive part of each PTX statement, and the C++ that replaces it.
ASM = [
    ("cp.async.cg.shared.global [%0], [%1], 16;", "emu_cp_async(smem, gmem, 16);"),
    ("cp.async.ca.shared.global [%0], [%1], 8;", "emu_cp_async(smem, gmem, 8);"),
    ("cp.async.ca.shared.global [%0], [%1], 4;", "emu_cp_async(smem, gmem, 4);"),
    ("cp.async.commit_group", ";"),
    ("cp.async.wait_group", ";"),
    ("ex2.approx.ftz.f32", "y = emu_ex2(x);"),
    ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", "emu_mma<true>(d, a, b0, b1);"),
    ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32", "emu_mma<false>(d, a, b0, b1);"),
    ("movmatrix.sync.aligned.m8n8.trans.b16", "y = emu_transpose8(x);"),
    ("cvt.rna.tf32.f32", "y = (f2u(x) + 0x1000u) & 0xffffe000u;"),
    ("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16", "emu_ldmatrix(r, p, true);"),
    ("ldmatrix.sync.aligned.m8n8.x4.shared.b16", "emu_ldmatrix(r, p, false);"),
]


def _statement_end(src: str, start: int) -> int:
    """Index just past the ``;`` that ends the asm statement at ``start``."""
    depth, i = 0, src.index("(", start)
    while True:
        ch = src[i]
        if ch == '"':
            i = src.index('"', i + 1)
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return src.index(";", i) + 1
        i += 1


def translate(src: str) -> str:
    out, pos = [], 0
    for m in re.finditer(r"(?<![\w])asm(\s+volatile)?\s*\(", src):
        if m.start() < pos:
            continue
        end = _statement_end(src, m.start())
        stmt = src[m.start():end]
        rep = next((r for key, r in ASM if key in stmt), None)
        if rep is None:
            raise SystemExit(f"unknown asm statement: {stmt[:100]}")
        out += [src[pos:m.start()], rep]
        pos = end
    src = "".join(out) + src[pos:]
    src = src.replace("extern __shared__ __align__(16) char smem[];",
                      "char* smem = emu::block_smem();")
    src = re.sub(r"^(\s*)(\S.*?)<<<(.*?)>>>\(", r"\1emu::launch(\2, \3)(", src, flags=re.M)
    if "<<<" in src:
        raise SystemExit("a launch was not translated")
    return src


if __name__ == "__main__":
    sys.stdout.write(translate(open(sys.argv[1]).read()))
