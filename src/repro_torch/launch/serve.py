"""Serving launcher (the port of `repro/launch/serve.py`): token generation.

  * ``tokens`` — batched greedy generation through the model stack, plus
    the DxPTA co-design report; the default when no subcommand is given::

        PYTHONPATH=src python -m repro_torch.launch.serve tokens \\
            --arch qwen2.5-3b

    serves the full published config with random weights on the card
    (``--device cpu --reduced`` runs a tiny same-family config here).

The ``dse`` and ``scenarios`` subcommands wait for the service and the
scenario sweep (ROADMAP Queue 1 items 11 and 12).
"""
from __future__ import annotations

import argparse
import sys

_NOT_PORTED = {"dse": "the resident DSE service (ROADMAP Queue 1 item 11)",
               "scenarios": "the scenario sweep (ROADMAP Queue 1 item 12)"}


def _tokens_main(args) -> None:
    """Batched greedy generation + co-design report."""
    import numpy as np

    from .. import models as M
    from .._device import resolve_device
    from ..configs import get_config, list_archs, reduced
    from ..train.serve import Request, Server, photonic_report

    if args.arch not in list_archs():
        raise SystemExit(f"unknown arch {args.arch!r}; pick from "
                         f"{list_archs()}")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = M.init_params(cfg, device=dev)
    srv = Server(cfg, params, batch_size=args.batch, max_len=args.max_len,
                 device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=8).astype(np.int32),
                    max_new=args.max_new) for _ in range(args.batch)]
    stats = srv.generate(reqs)
    print(f"{stats['tokens']} tokens on {dev}: "
          f"ttft={stats['ttft_s']*1e3:.1f}ms "
          f"decode={stats['decode_s_per_tok']*1e3:.2f}ms/tok")
    print(photonic_report(get_config(args.arch), seq_len=args.max_len,
                          batch=args.batch, new_tokens=args.max_new,
                          device=dev))


def main(argv=None) -> None:
    """Dispatch to a subcommand (``tokens`` when none is given)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED:
        raise NotImplementedError(f"repro_torch.launch.serve {argv[0]}: "
                                  f"{_NOT_PORTED[argv[0]]} is not ported yet")
    if not argv or argv[0] != "tokens":
        argv.insert(0, "tokens")  # original flag-only invocation

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tk = sub.add_parser("tokens", help="batched greedy generation")
    tk.add_argument("--arch", required=True)
    tk.add_argument("--reduced", action="store_true")
    tk.add_argument("--batch", type=int, default=4)
    tk.add_argument("--max-new", type=int, default=8)
    tk.add_argument("--max-len", type=int, default=64)
    tk.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the plain PyTorch path)")
    _tokens_main(ap.parse_args(argv))


if __name__ == "__main__":
    main()
