"""Subprocess replica entry point — the port of
``paddle_tpu/serving/replica_main.py``'s generation replica.

    python -m paddle_tpu_torch.serving.replica_main --gen NAME [--device cpu]

starts an :class:`~paddle_tpu_torch.io.serving.InferenceServer` on a free
port (``--port 0``, the default), prints ``ENDPOINT host:port`` and then
``PID <pid>`` on standard output, and serves until the wire ``stop`` op
or SIGTERM (SIGINT too); both drain gracefully (``FLAGS_wire_drain_s``).
One replica is one OS process, killable with SIGKILL.

``--gen NAME`` registers a continuous-batching generation engine under
``NAME`` over a tiny Llama (``LlamaConfig.tiny(vocab_size=96,
hidden_size=32, num_layers=2, num_heads=2, num_kv_heads=2,
max_seq_len=64)``, the JAX replica's configuration) drawn from
``--gen-seed``: every replica of the port started with one seed on one
kind of device holds the same weights, so greedy streams compare across
replicas. The weights are not the JAX replica's (Philox against
threefry). The model is built on the card unless ``--device cpu`` is
given. ``--gen-slots``, ``--gen-max-len``, ``--gen-step-wait-s``,
``--gen-paged`` and ``--gen-page-tokens`` configure the engine.

``FLAGS_*`` environment variables apply as usual (the flag registry reads
them when it is imported).

The JAX replica's other options are not ported and raise
``NotImplementedError`` naming their ROADMAP item: ``--gen-spec-k``,
``--gen-spec-mode``, ``--gen-async-depth`` and ``--gen-device-pt``
(A2c); ``--kv-*``, ``--role`` and ``--gen-sched*`` (A2d); ``--mesh-tp``
(A6); ``--emb-*`` (A2d) and the ``name=path`` artifact positionals (A7).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

# option (argparse dest) -> the ROADMAP item that ports it
_UNPORTED = {
    "gen_spec_k": "A2c", "gen_spec_mode": "A2c", "gen_async_depth": "A2c",
    "gen_device_pt": "A2c",
    "kv_store": "A2d", "kv_spill_dir": "A2d", "kv_fetch_timeout_s": "A2d",
    "kv_hedge_ms": "A2d", "kv_breaker": "A2d",
    "kv_breaker_backoff_s": "A2d", "kv_peers": "A2d", "role": "A2d",
    "gen_sched": "A2d", "gen_sched_quotas": "A2d",
    "gen_sched_headroom": "A2d",
    "mesh_tp": "A6",
    "emb_ps": "A2d", "emb_table": "A2d", "emb_model": "A2d",
    "emb_seed": "A2d", "emb_cache_rows": "A2d", "emb_ttl_s": "A2d",
    "models": "A7",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("models", nargs="*", metavar="name=path",
                    help="exported artifacts to serve (not ported: A7)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (read it from the ENDPOINT "
                         "line)")
    ap.add_argument("--device", default=None,
                    help="device of the --gen model: 'cpu', or the card "
                         "(the default)")
    ap.add_argument("--gen", default=None, metavar="NAME",
                    help="register a generation engine under NAME over a "
                         "tiny Llama drawn from --gen-seed")
    ap.add_argument("--gen-seed", type=int, default=7)
    ap.add_argument("--gen-slots", type=int, default=2)
    ap.add_argument("--gen-max-len", type=int, default=32)
    ap.add_argument("--gen-step-wait-s", type=float, default=0.0,
                    help="engine pacing knob (slows decode so that a "
                         "harness can act mid-stream)")
    ap.add_argument("--gen-paged", action="store_true",
                    help="paged KV cache for the --gen engine")
    ap.add_argument("--gen-page-tokens", type=int, default=8)
    # the JAX replica's options this port does not carry yet: given, they
    # raise (None / False: not given)
    for opt in ("--gen-spec-k", "--gen-async-depth", "--mesh-tp",
                "--kv-breaker", "--gen-sched-headroom", "--emb-seed",
                "--emb-cache-rows"):
        ap.add_argument(opt, type=int, default=None)
    for opt in ("--kv-fetch-timeout-s", "--kv-hedge-ms",
                "--kv-breaker-backoff-s", "--emb-ttl-s"):
        ap.add_argument(opt, type=float, default=None)
    for opt in ("--gen-spec-mode", "--role", "--kv-spill-dir", "--kv-peers",
                "--gen-sched-quotas", "--emb-ps", "--emb-table",
                "--emb-model"):
        ap.add_argument(opt, default=None)
    for opt in ("--gen-device-pt", "--kv-store", "--gen-sched"):
        ap.add_argument(opt, action="store_true")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    for dest, item in _UNPORTED.items():
        if getattr(args, dest) not in (None, False, []):
            opt = ("name=path positionals" if dest == "models"
                   else "--" + dest.replace("_", "-"))
            raise NotImplementedError(
                f"replica_main {opt}: not ported yet (ROADMAP {item})")

    from paddle_tpu_torch.core.flags import flag
    from paddle_tpu_torch.io.serving import InferenceServer

    model = None
    if args.gen:
        from paddle_tpu_torch.device import make_generator
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

        cfg = LlamaConfig.tiny(vocab_size=96, hidden_size=32,
                               num_layers=2, num_heads=2, num_kv_heads=2,
                               max_seq_len=64)
        model = LlamaForCausalLM(cfg, device=args.device,
                                 generator=make_generator(args.gen_seed,
                                                          args.device))
    srv = InferenceServer(host=args.host, port=args.port)
    if model is not None:
        srv.add_generator(args.gen, model, slots=args.gen_slots,
                          max_len=args.gen_max_len,
                          step_wait_s=args.gen_step_wait_s,
                          paged=args.gen_paged,
                          page_tokens=args.gen_page_tokens)
    srv.start()
    print(f"ENDPOINT {srv.endpoint}", flush=True)
    print(f"PID {os.getpid()}", flush=True)

    def _term(signum, frame):        # preemption: drain, then exit
        srv.stop(drain_s=float(flag("wire_drain_s")))

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    # serve until stopped (the wire stop op, or the handler above) and
    # drained: in-flight requests finish before the process exits
    while not srv.stopped.wait(0.2):
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
