"""The port's subprocess replica (``python -m
paddle_tpu_torch.serving.replica_main``) on the CPU: it prints its
``ENDPOINT``, two replicas started with one seed stream the same greedy
tokens, the wire ``stop`` op and SIGTERM drain it (the process exits 0),
and the JAX replica's options that are not ported raise naming their
ROADMAP item. At most two subprocesses at a time, each waited for with a
bound."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.io import serving as jax_serving

from paddle_tpu_torch.io import InferenceClient
from paddle_tpu_torch.serving import replica_main

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parent.parent


def _spawn(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.replica_main",
         "--gen", "g", "--device", "cpu", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env)
    line = proc.stdout.readline()
    assert line.startswith("ENDPOINT "), (line, proc.stderr.read()
                                          if proc.poll() is not None else "")
    assert proc.stdout.readline() == f"PID {proc.pid}\n"
    return proc, line.split()[1]


def test_two_replicas_one_seed_stream_alike_and_drain():
    procs = [_spawn("--gen-paged", "--gen-max-len", "48"), _spawn()]
    try:
        prompt = np.arange(3, 14, dtype=np.int32)
        streams = []
        for (proc, ep), cls in zip(procs, (InferenceClient,
                                           jax_serving.InferenceClient)):
            with cls(ep, timeout=60.0) as c:
                streams.append(list(c.generate("g", prompt, 8)))
                h = c.health()
                assert h["generators"]["g"]["device"]["platform"] == "cpu"
        assert streams[0] == streams[1] and len(streams[0]) == 8
        assert h["generators"]["g"]["paged"] is False
        # the stop op on one, SIGTERM on the other: both drain and exit 0
        with InferenceClient(procs[0][1], timeout=10.0) as c:
            c.stop_server()
        procs[1][0].send_signal(signal.SIGTERM)
        for proc, _ in procs:
            assert proc.wait(timeout=30) == 0
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdout.close()
            proc.stderr.close()


@pytest.mark.parametrize("argv,item", [
    (["--gen-spec-k", "4"], "A2c"), (["--gen-async-depth", "1"], "A2c"),
    (["--gen-spec-mode", "draft"], "A2c"), (["--gen-device-pt"], "A2c"),
    (["--kv-store"], "A2d"), (["--kv-spill-dir", "/tmp/x"], "A2d"),
    (["--role", "decode"], "A2d"), (["--gen-sched"], "A2d"),
    (["--gen-sched-quotas", "a=1"], "A2d"), (["--mesh-tp", "2"], "A6"),
    (["--emb-ps", "h:1"], "A2d"), (["m=/x"], "A7")])
def test_unported_options_raise_naming_their_item(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        replica_main.main(["--gen", "g", "--device", "cpu", *argv])


def test_replica_runs_on_the_card_by_default():
    """Without ``--device`` the model is built on the card; on a host
    without one that raises before any server is started."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        replica_main.main(["--gen", "g"])
