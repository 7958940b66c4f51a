"""Build and bind the port's CUDA kernels (no counterpart in the JAX package,
whose Pallas kernels compile inside `pallas_call`).

The kernels under `mlx_vlm_tpu_torch/csrc/` are compiled for `sm_90a`, one
`nvcc` process per source, all started together, then linked into one
shared library with a plain C interface and loaded with ctypes.  The build
runs at first use, into `mlx_vlm_tpu_torch/build/`, keyed by a hash of the
sources, headers and flags, so a fresh checkout builds everything the first
time a kernel launches.  Nothing here runs at import time.

Each wrapper counts its kernel's launches in its module's `launches` by
`count`, which counts launches that execute: a launch made while a CUDA
graph is captured only puts the kernel into the graph, so a `Graph` keeps
it in the tally of its capture and counts it at each replay.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("int4_matmul.cu", "int4_matvec.cu", "flash_attention.cu",
           "fused_decode.cu", "int4_kv_attention.cu", "tq_kv_attention.cu",
           "qmatmul.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# ptxas's report (registers, spills, shared memory) of each source compiled
# by this process, filled by `library()` when it builds
BUILD_LOG: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types (each returns a cudaError_t as int)
_SIGNATURES = {
    # x, qp, sl, sh, bl, bh, y, part, M, K, N2p, n, group_size, bm, splits,
    # stream
    "mvt_int4_matmul": (_P,) * 8 + (_I,) * 7 + (_P,),
    # x, qp, sl, sh, bl, bh, y, M, K, N2p, n, group_size, slices, stream
    "mvt_int4_matvec": (_P,) * 7 + (_I,) * 6 + (_P,),
    # q, k, v, o, offset, left_pad, B, H, KVH, S, C, scale, window, stream
    "mvt_flash_attention": (_P,) * 6 + (_I,) * 5 + (_F, _I, _P),
    # FusedDecodeArgs*, stream
    "mvt_fused_decode": (_P, _P),
    # dynamic shared memory bytes
    "mvt_fused_decode_grid": (_I,),
    # q8, qmeta, k4, ks, kb, v4, vs, vb, offset, left_pad, part_ml, part_acc,
    # tickets, out, BH, G, C, D, tokens, warps, combiners, smem, scale,
    # stream
    "mvt_int4_kv_attention": (_P,) * 14 + (_I,) * 8 + (_F, _P),
    # q, 2 x (kq, ks, vq, vs, klut, vlut), offset, left_pad, part_ml,
    # part_acc, tickets, out, 2 x (d, kbits, vbits), nseg, BH, G, C,
    # tokens, warps, combiners, smem, scale, stream
    "mvt_tq_kv_attention": (_P,) * 19 + (_I,) * 14 + (_F, _P),
    # x, q, scales, biases, y, M, K, N, bits, group_size, row_tiles, chunks,
    # stream
    "mvt_qmatmul_gemv": (_P,) * 5 + (_I,) * 7 + (_P,),
    # x, q, scales, biases, y, part, M, K, N, bits, group_size, bm, splits,
    # stream
    "mvt_qmatmul_gemm": (_P,) * 6 + (_I,) * 7 + (_P,),
    # x, q, scales, biases, y, experts, rows, pairs, E, K, N, bits,
    # group_size, row_tiles, chunks, stream
    "mvt_qmatmul_gemv_experts": (_P,) * 7 + (_I,) * 8 + (_P,),
}


def source_paths() -> list:
    return [CSRC_DIR / s for s in SOURCES]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [*source_paths(), *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmvt_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> list:
    """Run the commands in parallel and return their output; raise with
    nvcc's output on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed, outs = [], []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outs


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built on first call if its hash is not on disk."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = so.with_suffix(f".{os.getpid()}")
        objs = [Path(f"{stem}.{p.stem}.o") for p in source_paths()]
        outs = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                         for p, o in zip(source_paths(), objs)])
        BUILD_LOG.update({p.name: out for p, out in zip(source_paths(), outs)})
        tmp = Path(f"{stem}.tmp")
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        for o in objs:
            o.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mvt_error_string.argtypes = (ctypes.c_int,)
    lib.mvt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().mvt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


# The launch tallies of the `Graph` captures in progress (innermost last)
_CAPTURES: list = []


def count(launches: dict, name: str) -> None:
    """Count one launch of kernel `name` in `launches` where it executes: a
    call made while the current stream is captured adds it to the tally of
    the `Graph` being captured (a capture made elsewhere, such as a timing
    graph, counts nothing)."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        if _CAPTURES:
            _CAPTURES[-1].append((launches, name))
        return
    launches[name] += 1


class Graph:
    """A CUDA graph of calls whose replays count the kernel launches that
    the capture recorded, once per replay."""

    def __init__(self):
        import torch

        self.graph = torch.cuda.CUDAGraph()
        self.tally: list = []

    def capture(self, fn, stream, generators=()) -> None:
        """Capture fn() on `stream`; `generators` are the torch.Generators
        that fn draws from, whose state each replay advances.  The capture
        begins at once: unlike `torch.cuda.graph`, it does not wait for the
        card, collect garbage or empty the allocator's cache first, which
        is host time per request.  Python's garbage collector is kept off
        while it runs: a collection there could free an unreachable object
        that holds CUDA events or a captured graph (a generator left in a
        reference cycle), and destroying those is an operation that a
        capture in "global" mode refuses, which invalidates the capture."""
        import gc

        import torch

        for gen in generators:
            self.graph.register_generator_state(gen)
        _CAPTURES.append(self.tally)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin()
                try:
                    fn()
                finally:
                    self.graph.capture_end()
        finally:
            _CAPTURES.pop()
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()
        for launches, name in self.tally:
            launches[name] += 1
