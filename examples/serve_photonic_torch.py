"""End-to-end example (deliverable (b)) on the port (PyTorch): serve a small
model with batched requests through the photonic-simulation path,
`examples/serve_photonic.py` through `repro_torch`.

The paper is an inference-accelerator DSE paper, so the e2e example is a
*server*: (1) DxPTA searches a PTA for the serving workload, (2) the model
serves batched requests on the device (random weights from a generator on
it seeded with 0), with its LM head optionally routed through the
4-bit DDot kernel (`ddot_gemm_quantized`, the photonic functional
simulation), and (3) the DxPTA cost model reports what the same batch
costs on the found PTA.

    PYTHONPATH=src python examples/serve_photonic_torch.py [--arch qwen2.5-3b]
        [--photonic]   # route the LM head through kernels.photonic_matmul
    # on the card by default; --device cpu runs the plain PyTorch versions
"""
import argparse
import time

import numpy as np
import torch

import repro_torch.models as M
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.kernels import photonic_matmul
from repro_torch.models.layers import set_exec_safe
from repro_torch.train.serve import Request, Server, photonic_report


def photonic_head(x, table, noise_rms, key_data, device):
    """The LM head `x @ table.T` through the 4-bit DDot path
    (`photonic_matmul`, shot noise from a generator on `device` seeded with
    `key_data`) beside the float32 product. Returns (logits_q, logits_f,
    rel_err), rel_err the Frobenius norm of their difference over that of
    logits_f."""
    table_t = table.T.float()
    logits_q = photonic_matmul(x, table_t, noise_rms=noise_rms,
                               key_data=key_data, device=device)
    logits_f = x @ table_t
    err = float(torch.linalg.norm(logits_q - logits_f)
                / torch.linalg.norm(logits_f))
    return logits_q, logits_f, err


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--photonic", action="store_true",
                    help="4-bit DDot-kernel logits (functional PTA sim)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)
    set_exec_safe(True)

    cfg = reduced(get_config(args.arch))
    print(f"model: {cfg.name} ({cfg.family}), vocab={cfg.vocab}")
    params = M.init_params(cfg, device=args.device)
    dev = params.embed.table.device

    srv = Server(cfg, params, batch_size=args.batch, max_len=64,
                 device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=rng.integers(4, 12)
                                        ).astype(np.int32),
                    max_new=args.max_new) for _ in range(args.batch)]
    stats = srv.generate(reqs)
    print(f"served {len(reqs)} requests, {stats['tokens']} tokens: "
          f"ttft={stats['ttft_s']*1e3:.1f} ms, "
          f"decode={stats['decode_s_per_tok']*1e3:.2f} ms/tok (on {dev})")
    print("sample output tokens:", reqs[0].out)
    out = {"stats": stats, "tokens": reqs[0].out, "rel_err": None}

    if args.photonic:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        x = torch.randn((args.batch, cfg.d_model), generator=gen, device=dev)
        t0 = time.perf_counter()
        _, _, err = photonic_head(x, params.embed.table, 0.02, 7, dev)
        what = ("the ddot_gemm_quantized kernel" if dev.type == "cuda"
                else "its plain PyTorch version")
        print(f"photonic (4-bit DDot kernel + shot noise) LM head: "
              f"rel_err={err:.3f} vs fp32  "
              f"({(time.perf_counter()-t0)*1e3:.0f} ms on {dev}: {what}, "
              f"quantization included)")
        out["rel_err"] = err

    print("\n== DxPTA co-design report: this workload on the found PTA ==")
    rep = photonic_report(get_config(args.arch), seq_len=64,
                          batch=args.batch, new_tokens=args.max_new,
                          device=args.device)
    for k, v in rep.items():
        print(f"  {k}: {v}")
    out["report"] = rep
    return out


if __name__ == "__main__":
    main()
