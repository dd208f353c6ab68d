"""Build and load the port's CUDA kernels.

`csrc/*.cu` are compiled by `nvcc`, one process per source and all at once,
and linked into one shared library with a plain C interface,
`_build/libmtp_kernels.so`, loaded with ctypes.  The build happens at the
first launch on a CUDA tensor (never at import) and again whenever a source
is newer than the library.  There is no fallback: a missing `nvcc` or a
failed compile raises with the compiler's output.

Every launcher takes its pointers and the CUDA stream as `void*`, sizes as
`int`, and returns the `cudaError_t` of its launch (0 on success).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
LIB = BUILD / "libmtp_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# launcher name → argtypes; the trailing (dtype code, stream) are common
SIGNATURES = {
    # q, k, v, bias, out, W·nH, N, D, scale
    "mtp_window_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F],
    # q, k, v, bias, out, lse, W·nH, N, D, scale (K1L, whose backward is K7)
    "mtp_window_attn_fwd_large": [_P] * 6 + [_I, _I, _I, _F],
    # q, k, v, rel_h, rel_w, out, lse, BH, N, D, Hk, Wk, scale
    "mtp_flash_attn_fwd": [_P] * 7 + [_I] * 5 + [_F],
    # img, py, px, m, out, BG, H, W, C, HWo, P, body
    "mtp_bilinear_sample_fwd": [_P] * 5 + [_I] * 7,
    # q, k, v, bias, dout, dq, dk, dv, dbias, W·nH, N, D, scale
    "mtp_window_attn_bwd": [_P] * 9 + [_I, _I, _I, _F],
    # q, k, v, bias, out, lse, dout, dq, dk, dv, dbias, delta, W·nH, N, D,
    # scale
    "mtp_window_attn_bwd_qblk": [_P] * 12 + [_I, _I, _I, _F],
    # q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h, drel_w,
    # delta, BH, N, D, Hk, Wk, scale
    "mtp_flash_attn_bwd": [_P] * 14 + [_I] * 5 + [_F],
    # img, py, px, m, g, dimg (fp32), dpy, dpx, dm, BG, H, W, C, HWo, P, body
    "mtp_bilinear_sample_bwd": [_P] * 9 + [_I] * 7,
    # boxes, scores (score order), mask (scratch), lists (int32 scratch),
    # keep, B, N, iou_thr (N1)
    "mtp_nms": [_P] * 5 + [_I, _I, _F],
    # a, b, out, B, N, M, iof (R1, dense)
    "mtp_rbox_iou": [_P] * 3 + [_I] * 4,
    # boxes, scores (score order), mask (scratch), lists (int32 scratch),
    # keep, B, N, iou_thr (R1, mask form, then N1's scan)
    "mtp_nms_rotated": [_P] * 5 + [_I, _I, _F],
}

# storage types the kernels are instantiated for (csrc/common.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
# ptxas's report (registers, shared memory, spills per kernel) of the last
# compile in this process
PTXAS_LOG: list[str] = []


def find_nvcc() -> str:
    """`nvcc` on PATH, else `$CUDA_HOME/bin/nvcc` (CUDA_HOME defaults to
    /usr/local/cuda).  Raises if neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        f"nvcc not found on PATH or at {cand}: the CUDA kernels of "
        f"mtp_tpu_torch cannot be built (set CUDA_HOME or PATH)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def stale(lib: Path = LIB) -> bool:
    """True when the library is missing or older than any source."""
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(p.stat().st_mtime > built
               for p in sources() + sorted(CSRC.glob("*.cuh")))


def build(force: bool = False) -> Path:
    """Compile `csrc/*.cu` into `_build/libmtp_kernels.so` if stale: one
    `nvcc -c` per source, all started together, then one link."""
    if not force and not stale():
        return LIB
    nvcc = find_nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [BUILD / f"{src.stem}.{tag}.o" for src in sources()]
    jobs = []
    try:
        for src, obj in zip(sources(), objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        logs = []
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
            logs.append(out)
        tmp = LIB.with_suffix(f".{tag}.tmp")
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, LIB)
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    PTXAS_LOG[:] = _ptxas_summary("\n".join(logs))
    return LIB


def kernel_label(mangled: str) -> str:
    """`name<args>` of a mangled kernel template of csrc/, e.g.
    flash_fwd_tc_kernel<64>, flash_attn_fwd_kernel<f> (float),
    window_attn_fwd_kernel<nv_bfloat16>,
    bilinear_sample_bwd_vec_kernel<nv_bfloat16, 9, true>; the mangled name
    if it is none."""
    entry = re.search(r"\d+([a-z_]+_kernel)I", mangled)
    if not entry:
        return mangled
    rest, args = mangled[entry.end():], []
    while rest and rest[0] != "E":
        literal = re.match(r"L([a-z])(\d+)E", rest)   # an int or bool argument
        named = re.match(r"(\d+)", rest)               # a named type
        if literal:
            value = literal[2]
            args.append({"0": "false", "1": "true"}[value] if literal[1] == "b" else value)
            rest = rest[literal.end():]
        elif named:
            end = named.end() + int(named[1])
            args.append(rest[named.end():end].strip("_"))
            rest = rest[end:]
        else:                                          # a builtin type: f
            args.append(rest[0])
            rest = rest[1:]
    return f"{entry[1]}<{', '.join(args)}>"


def _ptxas_summary(text: str) -> list[str]:
    """One line per compiled kernel from `-Xptxas -v`: registers, spills."""
    out = []
    for line in text.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            out.append(f"{kernel_label(entry[1])}:")
        elif out and ("registers" in line or "spill" in line):
            out[-1] += " " + line.split(":")[-1].strip()
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args + [_I, _P]
            fn.restype = _I
        _lib = handle
    return _lib


def use_kernel(*tensors: torch.Tensor) -> bool:
    """Dispatch by device: True when every tensor lies on one CUDA device
    (launch the kernel), False when all lie on the CPU (run the plain
    version).  Anything else raises; there is no switch and no fallback."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {device}")


def check_on_card(kernel: str, *tensors: torch.Tensor) -> None:
    """The box kernels (N1, R1) take fp32 tensors on one CUDA device and
    nothing else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel} runs on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{kernel} takes torch.float32, got {[t.dtype for t in tensors]}")


def check_launchable(**tensors: torch.Tensor) -> None:
    """The kernels take dense row-major storage only."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def check_aligned(**tensors: torch.Tensor) -> None:
    """Kernels that copy rows with 16-byte `cp.async` (the flash kernels,
    K1L and K7, and K1's and K4's tensor-core bodies) take only
    16-byte-aligned storage."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the CUDA kernel "
                             f"(data_ptr % 16 = {t.data_ptr() % 16})")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"CUDA kernels take {list(DTYPE_CODES)}, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def launch(name: str, *args) -> None:
    """Call launcher `name` on the current stream; raise on a launch error."""
    err = getattr(lib(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {err}")
