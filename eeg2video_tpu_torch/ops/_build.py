"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` (one ``nvcc``
for each source, all started together) and link into one shared library
with a plain C interface, loaded through ``ctypes``. The build happens at
first use, never at import, into
``eeg2video_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``), keyed by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the existing library.

Each C entry point returns the CUDA launch status, or DOES_NOT_FIT for a
call whose operands do not fit a block's shared memory; ``check`` raises on
any non-zero value (a ValueError naming the kernel for DOES_NOT_FIT).
``launches`` counts, per kernel, the launches its wrapper made; a wrapper
adds one only where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float
# C signatures of the entry points (argtypes; every restype is int)
SIGNATURES = {
    "e2v_flash_attention_fwd": [P, LL, LL, P, LL, P, LL, P, LL, LL, P, LL, LL,
                                P, P, LL, LL, I, I, I, I, I, I, I, F, P, P],
    "e2v_flash_attention_bwd": [ctypes.POINTER(P), ctypes.POINTER(LL),
                                ctypes.POINTER(I), F, P],
    "e2v_fused_attention_fwd": [P, LL, LL, P, LL, LL, P, LL, LL, P, LL, LL,
                                I, I, I, I, I, F, P, P],
    "e2v_fused_attention_bwd": [ctypes.POINTER(P), ctypes.POINTER(LL),
                                ctypes.POINTER(I), F, P],
    "e2v_temporal_attention_fwd": [P, P, P, P, LL, LL, I, I, I, I, I, F, P],
    "e2v_temporal_attention_bwd": [P, P, P, P, P, P, P, LL, LL, I, I, I, I, I, F, P],
    "e2v_ff_ln": [P, P, P, P, P, P, P, P, I, I, I, I, F, P, I],
    "e2v_ff_ln_bwd": [P, P, P, P, P, P, P, P, I, I, I, I, F, P, I],
    "e2v_ff_ln_bwd_block_rows": [I],
    "e2v_geglu_out": [P, P, P, P, I, I, I, P],
    "e2v_geglu_out_bwd": [P, P, P, P, I, I, I, P],
    "e2v_conv3x3": [P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    "e2v_int8_dense": [P, P, P, P, P, P, LL, I, I, I, I, I, P],
    "e2v_int8_dense_plan": [I, I, I, I, ctypes.POINTER(LL)],
    # the f32 kernels
    "e2v_flash_f32_fwd": [ctypes.POINTER(P), ctypes.POINTER(LL), ctypes.POINTER(I), F, P],
    "e2v_flash_f32_bwd": [ctypes.POINTER(P), ctypes.POINTER(LL), ctypes.POINTER(I), F, P],
    "e2v_temporal_attention_fwd_f32": [P, P, P, P, LL, LL, I, I, I, I, I, F, P],
    "e2v_temporal_attention_bwd_f32": [P, P, P, P, P, P, P, LL, LL, I, I, I, I, I, F, P],
    "e2v_ff_f32": [P, P, P, P, P, P, P, P, P, I, I, I, F, P, I],
    "e2v_ff_f32_bwd": [P, P, P, P, P, P, P, P, P, I, I, I, F, P, I],
    "e2v_geglu_f32": [P, P, P, P, P, I, I, I, P],
    "e2v_geglu_f32_bwd": [P, P, P, P, I, I, I, P],
    # the bandpass recursion (csrc/sos_filtfilt.cu; no Pallas counterpart)
    "e2v_sos_filtfilt": [P, P, P, P, P, I, LL, I, I, I, I, I, P],
}

# "flash_attention_bwd_dbias" counts those launches of flash_attention_bwd
# that also wrote the gradient of bias0 (it is no kernel of its own). The
# "_f32" names count the f32 counterparts (csrc/*_f32.cu, the f32
# instantiation of the temporal pair, csrc/temporal_attention.cuh), which f32
# operands launch.
BF16_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_bwd_dbias",
                "fused_attention_fwd", "fused_attention_bwd",
                "temporal_attention_fwd", "temporal_attention_bwd",
                "ff_ln", "ff_ln_bwd", "geglu_out", "geglu_out_bwd")
F32_KERNELS = tuple(f"{k}_f32" for k in BF16_KERNELS)
# the filtfilt recursion of dsp.bandpass in float32 and in float64
IIR_KERNELS = ("sos_filtfilt", "sos_filtfilt_f64")
launches = dict.fromkeys((*BF16_KERNELS, "conv3x3_gn_silu", "int8_dense", *F32_KERNELS,
                          *IIR_KERNELS), 0)

_lib = None


def reset_launches():
    for k in launches:
        launches[k] = 0


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = os.path.join(BUILD_ROOT, _digest())
    so = os.path.join(out_dir, "libe2v_kernels.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        cus = [p for p in _sources() if p.endswith(".cu")]
        objs = [os.path.join(out_dir, f"{os.path.basename(p)}.{os.getpid()}.o") for p in cus]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu] for cu, obj in zip(cus, objs)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]

        def finish(proc):  # its output, and its end in seconds from the build's start
            out = proc.communicate()[0]
            return f"[{time.perf_counter() - t0:.1f} s]\n{out}"

        with ThreadPoolExecutor(len(procs)) as pool:  # every pipe drained at once
            outs = list(pool.map(finish, procs))
        results = [(cmd, out, proc.returncode) for cmd, proc, out in zip(cmds, procs, outs)]
        if all(rc == 0 for _, _, rc in results):
            link = [nvcc, "-shared", "-o", tmp, *objs]
            res = subprocess.run(link, capture_output=True, text=True)
            results.append((link, res.stdout + res.stderr, res.returncode))
        # -Xptxas -v: each kernel's registers, shared memory and spills;
        # [n s]: the seconds from the start of the build to that source's end
        build_log = "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in results)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(build_log)
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        failed = [rc for _, _, rc in results if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
        os.replace(tmp, so)  # atomic: a concurrent build never loads half a file
    lib = ctypes.CDLL(so)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def build_log():
    """The text of the loaded library's build.log (compiler output per source)."""
    with open(os.path.join(BUILD_ROOT, _digest(), "build.log")) as f:
        return f.read()


def kernel_resources(log: str):
    """{kernel: (registers, spill stores, spill loads)} from ``-Xptxas -v``
    output; a kernel is named by its function and template arguments, e.g.
    ``flash_fwd_kernel<48,1,0>``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _short_name(m.group(1))
            spills = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


# SASS opcodes of the conversion pipe (int <-> float, float <-> float)
CONVERSION_OPCODES = ("I2F", "F2F", "F2I", "I2FP", "F2FP", "I2I")


def sass_opcodes(prefix: str):
    """{kernel: {opcode: count}} of the loaded library's kernels whose short
    name starts with ``prefix``, from ``cuobjdump -sass`` (the opcode without
    its modifiers, e.g. ``PRMT``, ``HGMMA``)."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    so = os.path.join(BUILD_ROOT, _digest(), "libe2v_kernels.so")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = _short_name(part.split("\n", 1)[0].strip())
        if not name.startswith(prefix):
            continue
        count = out.setdefault(name, {})
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part):
            count[op] = count.get(op, 0) + 1
    return out


def source_seconds(log: str):
    """{source file: seconds from the start of the build to its end}."""
    return {os.path.basename(m.group(1)): float(m.group(2)) for m in
            re.finditer(r"-c -o \S+ (\S+\.cu)\n\[([\d.]+) s\]", log)}


def _short_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name ``e2v::...::name<args>``: the
    last of the nested names (namespaces, anonymous ones mangled with a
    per-file suffix, then the kernel's own)."""
    if not mangled.startswith("_ZN3e2v"):
        return mangled
    pos, base = len("_ZN3e2v"), None
    while (m := re.match(r"\d+", mangled[pos:])) is not None:
        ln = int(m.group(0))
        base = mangled[pos + m.end():pos + m.end() + ln]
        pos += m.end() + ln
    if base is None:
        return mangled
    args = re.findall(r"L[ib](\d+)E", mangled[pos:])
    return f"{base}<{','.join(args)}>" if args else base


DOES_NOT_FIT = -1  # csrc/temporal_plan.cuh kDoesNotFit


def check(rc: int, kernel: str):
    if rc == DOES_NOT_FIT:
        raise ValueError(f"{kernel}: the operands of one work item do not fit a block's "
                         "shared memory")
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def ptr(t):
    """Device address of a tensor, or NULL for an absent operand."""
    return None if t is None else t.data_ptr()


def stream_of(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned16(t):
    """``t`` (contiguous) at a 16-byte aligned address: a copy where a view's
    offset puts it elsewhere (the kernels read it in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require(cond: bool, kernel: str, what: str):
    if not cond:
        raise ValueError(f"{kernel}: {what}")
