"""The port stands alone: ``paddle_tpu_torch``, ``chip_smoke.py`` and the
card tests (``tests/test_torch_card.py``) import neither ``jax`` nor the
JAX package, and the entry points run on the GPU unless the caller asks
for the CPU — on this host, which has no CUDA, they raise."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_card.py"]
FORBIDDEN = ("jax", "paddle_tpu", "jaxlib")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_import_pulls_in_no_jax():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.models, "
            "paddle_tpu_torch.bridge, paddle_tpu_torch.kernels, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.core, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.io, paddle_tpu_torch.core.wire, "
            "paddle_tpu_torch.serving.ledger, "
            "paddle_tpu_torch.serving.replica_main\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_card_tests_collect_without_jax():
    """``tests/test_torch_card.py`` collects (and, without a GPU, skips)
    on a host where importing ``jax`` or the JAX package fails, as on the
    card's host: run without the repository's conftest, which imports
    JAX."""
    code = ("import sys\n"
            f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
            "import pytest\n"
            "sys.exit(pytest.main(['--noconftest', '-q', '-p', "
            "'no:cacheprovider', 'tests/test_torch_card.py']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "error" not in out.stdout.lower(), out.stdout
    want = "passed" if torch.cuda.is_available() else "skipped"
    assert want in out.stdout, out.stdout


def test_every_kernel_has_a_source():
    for name in _support.KERNELS:
        assert (_support.CSRC / f"{_support.SOURCES[name]}.cu").is_file(), \
            name


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError):
        port_device.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError):
        port_device.make_generator(0)


def test_explicit_cpu_builds_on_cpu():
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())
    assert m.init_cache(1, 4)[0].device.type == "cpu"


def test_cpu_run_builds_nothing():
    """A CPU generate runs the plain versions only: no kernel counted."""
    _support.reset_launches()
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    m.generate(torch.zeros((1, 4), dtype=torch.long), 3)
    assert all(n == 0 for n in _support.LAUNCHES.values())


def test_scan_and_int8_kernels_are_counted_and_sourced():
    """The Mamba scan (forward, backward) and the int8 decode layout each
    have their own launch counter and their source in csrc/."""
    assert {"selective_scan": "selective_scan",
            "selective_scan_bwd": "selective_scan",
            "decode_attention_int8": "decode_attention"}.items() <= \
        _support.SOURCES.items()
    for name in ("selective_scan", "selective_scan_bwd",
                 "decode_attention_int8"):
        assert name in _support.LAUNCHES


def test_cpu_mamba_and_int8_runs_build_nothing():
    """A CPU Mamba generate and a CPU int8-cache Llama generate run the
    plain versions only: no kernel counted."""
    from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
    _support.reset_launches()
    ids = torch.zeros((1, 4), dtype=torch.long)
    MambaForCausalLM(MambaConfig.tiny(), device="cpu").generate(ids, 3)
    LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").generate(
        ids, 3, cache_dtype=torch.int8)
    assert all(n == 0 for n in _support.LAUNCHES.values())


def test_mamba_default_device_raises_without_cuda():
    from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError):
        MambaForCausalLM(MambaConfig.tiny())


def test_new_modules_are_covered():
    """The serving engine, the host-side core copies and the kernel
    modules of this slice are among the files the source check reads,
    and the two new kernels have their counters and sources."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("serving/engine.py", "serving/__init__.py", "core/flags.py",
                "core/monitor.py", "core/trace.py", "core/fault.py",
                "kernels/softmax_xent.py",
                "kernels/paged_decode_attention.py"):
        assert f"paddle_tpu_torch/{rel}" in names, rel
    assert {"softmax_xent_lse": "softmax_xent",
            "softmax_xent_dx": "softmax_xent",
            "paged_decode_attention": "paged_decode_attention"}.items() <= \
        _support.SOURCES.items()


def test_engine_raises_without_cuda_by_default():
    """The engine builds on its model's device: a default-device model
    raises without a GPU before any engine exists."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    from paddle_tpu_torch.serving import GenerationEngine
    with pytest.raises(RuntimeError):
        GenerationEngine(LlamaForCausalLM(LlamaConfig.tiny()), slots=1)


def test_server_slice_modules_are_covered():
    """The frame protocol, the server and client, the request ledger and
    the replica are among the files the source check reads, and B10-int8
    has its counter in the paged decode source."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("core/wire.py", "io/__init__.py", "io/serving.py",
                "serving/ledger.py", "serving/replica_main.py"):
        assert f"paddle_tpu_torch/{rel}" in names, rel
    assert _support.SOURCES["paged_decode_attention_int8"] == \
        "paged_decode_attention"
    assert "ptt_paged_decode_attention_int8" in (
        _support.CSRC / "paged_decode_attention.cu").read_text()


def test_server_entry_points_run_on_the_card_by_default():
    """A server's generator builds on its model's device: a default-device
    model raises without a GPU before any engine or server serves."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    from paddle_tpu_torch.io import InferenceServer
    srv = InferenceServer()
    with pytest.raises(RuntimeError):
        srv.add_generator("g", LlamaForCausalLM(LlamaConfig.tiny()),
                          slots=1)
    srv.stop()


def test_chip_smoke_names_every_kernel():
    """``chip_smoke.py``'s JSON line gives every counter the TPU kernel it
    replaces (a kernel without one would end the card's run in a
    KeyError)."""
    import chip_smoke
    assert set(chip_smoke.REPLACES) == set(_support.KERNELS)
    assert all(v.startswith("paddle_tpu/ops/pallas/")
               for v in chip_smoke.REPLACES.values())
