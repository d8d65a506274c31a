"""Batched serving: prefill + KV-cache decode over queued requests, on
one card (the reference's ``examples/serve_batched.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve_batched [--device cpu]

A reduced qwen2.5 (4 layers, d_model 256, 8 / 2 heads of 32, d_ff 512,
vocab 4,096, seeded random weights): 12 requests of 48 prompt tokens and
24 generated, served in waves of 4.
"""
from __future__ import annotations

import argparse


def example_config():
    """The example's reduced qwen2.5."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    return reduced(get_config("qwen2.5-3b"), n_layers=4, d_model=256,
                   n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512,
                   vocab=4096)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.launch.serve import make_requests, serve

    cfg = example_config()
    reqs = make_requests(cfg, 12, 48, 24)
    stats = serve(cfg, reqs, batch=4, max_len=48 + 24, device=args.device)
    print(f"served {stats['requests']} requests / {stats['tokens']} tokens "
          f"in {stats['wall_s']:.2f}s  ({stats['tok_per_s']:.0f} tok/s)")
    print(f"TTFT p50 {stats['ttft_p50_ms']:.1f} ms, "
          f"inter-token p50 {stats['itl_p50_ms']:.2f} ms")
    if stats["tokens"] != 12 * 24:
        raise AssertionError(f"served {stats['tokens']} tokens, want "
                             f"{12 * 24}")
    # greedy decode is deterministic across identical requests
    print("first completions:", stats["completions"])
    print("serving example OK")
    return stats


if __name__ == "__main__":
    main()
