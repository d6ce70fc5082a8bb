"""Build, dispatch and launch counting for the port's CUDA kernels — the
counterpart of ``paddle_tpu/ops/pallas/_support.py``.

Build. Each source ``paddle_tpu_torch/csrc/<source>.cu`` compiles on its
own into ``paddle_tpu_torch/_build/<source>-<hash>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

and is loaded with ``ctypes`` (plain C entry points, pointers as
``c_void_p``, the stream from ``torch.cuda.current_stream().cuda_stream``).
The hash covers the source, the shared header and the flags, so an
edited source rebuilds and an unchanged one is reused. ``build()``
starts one ``nvcc`` per source, all together, and waits for them all.
Nothing builds at import: the first launch of a kernel builds it.

Dispatch. A wrapper hands a CPU tensor to its plain PyTorch version and
launches its kernel on a CUDA tensor. Inside ``force_reference()`` CUDA
tensors take the plain version too (``chip_smoke.py`` runs the same path
both ways on the card). The ``autograd.Function``s decide once, in their
forward, and their backward follows that decision: a forward run inside
``force_reference()`` is differentiated by the plain backward as well.
There is no fallback: a refused launch raises.

Counting. ``LAUNCHES[name]`` is a plain int that the wrapper raises by
one where it launches its kernel, and nowhere else. A CUDA graph is the
one exception the wrappers cannot see: under ``captured_launches()`` a
capture's increments (which launched nothing) are taken back and kept,
and each replay adds them again (``add_launches``), so the counts are the
launches the card ran. A kernel's name is
its counter's; ``SOURCES`` maps it to the ``.cu`` file that holds it
(one source may hold several kernels, e.g. the forward and backward of
RMSNorm, of LayerNorm, of the selective scan or of softmax
cross-entropy, or the two layouts of decode attention).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["KERNELS", "SOURCES", "LAUNCHES", "reset_launches",
           "captured_launches", "add_launches",
           "force_reference", "use_kernel", "build", "library", "check",
           "stream_of", "compute_dtype", "dtype_code"]

# kernel (launch counter) -> the csrc/<source>.cu that holds it
SOURCES = {
    "rms_norm": "rms_norm",
    "rms_norm_bwd": "rms_norm",
    "layer_norm": "layer_norm",
    "layer_norm_bwd": "layer_norm",
    "rope": "rope",
    "flash_attention": "flash_attention",
    "flash_attention_bwd_dq": "flash_attention_bwd",
    "flash_attention_bwd_dkdv": "flash_attention_bwd",
    "decode_attention": "decode_attention",
    "adamw": "adamw",
    "linear_xent_fwd": "linear_xent",
    "linear_xent_dh": "linear_xent",
    "linear_xent_dw": "linear_xent",
    "selective_scan": "selective_scan",
    "selective_scan_bwd": "selective_scan",
    "decode_attention_int8": "decode_attention",
    "softmax_xent_lse": "softmax_xent",
    "softmax_xent_dx": "softmax_xent",
    "paged_decode_attention": "paged_decode_attention",
}
KERNELS = tuple(SOURCES)
LAUNCHES = {name: 0 for name in KERNELS}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_HEADERS = ("common.cuh",)

_force_reference = False
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph capture: yields a dict that ends up holding the
    launches the capture recorded, kernel by kernel, and takes them back
    out of ``LAUNCHES`` (a capture launches nothing); ``add_launches``
    books them at each replay."""
    before = dict(LAUNCHES)
    counts: dict[str, int] = {}
    try:
        yield counts
    finally:
        for name, n in LAUNCHES.items():
            if n != before[name]:
                counts[name] = n - before[name]
                LAUNCHES[name] = before[name]


def add_launches(counts: dict[str, int]) -> None:
    """Book one replay of a captured graph's launches."""
    for name, n in counts.items():
        LAUNCHES[name] += n


@contextlib.contextmanager
def force_reference():
    """Run every wrapper's plain PyTorch version, on CUDA tensors too."""
    global _force_reference
    prev = _force_reference
    _force_reference = True
    try:
        yield
    finally:
        _force_reference = prev


def use_kernel(x: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor). False: plain version (CPU
    tensor, or inside ``force_reference``). Raises on other devices."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the port's kernels take "
                         "CUDA tensors, their plain versions CPU tensors")
    return not _force_reference


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: fp32 for bf16 and fp32
    tensors (as the kernels do), float64 for float64 (``gradcheck``)."""
    return torch.promote_types(t.dtype, torch.float32)


def dtype_code(t: torch.Tensor) -> int:
    """The C side's type tag: 0 float32, 1 bfloat16."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{err}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on "
                       "a machine with the CUDA toolkit")


def _target(source: str) -> Path:
    h = hashlib.sha1()
    for part in (CSRC / f"{source}.cu",) + tuple(CSRC / n for n in _HEADERS):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, Path]:
    """Compile the sources of the named kernels that are not built yet,
    one ``nvcc`` per source, all started together; raise with the
    compiler's output if any fails. Each ``<source>.log`` keeps
    ``ptxas``' register and shared memory report. Returns source →
    shared library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s: _target(s) for s in dict.fromkeys(SOURCES[n]
                                                     for n in names)}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode:
            failed.append(f"--- {name} ---\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library that holds kernel ``name``, built on
    first use."""
    source = SOURCES[name]
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[source]))
        _libs[source] = lib
    return lib
