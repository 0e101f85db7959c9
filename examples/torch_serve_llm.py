"""Serve a small LLM on the PyTorch port with batched prefill / decode,
with and without the FastCache decode gate: the counterpart of
examples/serve_llm.py.

    PYTHONPATH=src python examples/torch_serve_llm.py --requests 6 \\
        --new-tokens 24
    PYTHONPATH=src python examples/torch_serve_llm.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Request, ServingEngine


def run(engine, cfg, n, prompt_len, new_tokens, seed=0):
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        prompt_len).astype(np.int32),
                    max_new_tokens=new_tokens) for i in range(n)]
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    return done, toks, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced(args.arch).replace(dtype="float32")
    model = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0))

    eng = ServingEngine(model, max_batch=4, window=128)
    done, toks, dt = run(eng, cfg, args.requests, args.prompt_len,
                         args.new_tokens)
    print(f"exact     : {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s)")

    eng_fc = ServingEngine(model, max_batch=4, window=128,
                           fastcache=FastCacheConfig())
    done_fc, toks_fc, dt_fc = run(eng_fc, cfg, args.requests,
                                  args.prompt_len, args.new_tokens)
    st = eng_fc.cache_stats()
    print(f"fastcache : {toks_fc} tokens in {dt_fc:.2f}s "
          f"({toks_fc/dt_fc:.1f} tok/s, block cache ratio "
          f"{st['block_cache_ratio']:.1%})")
    agree = np.mean([np.mean(np.array(a.generated) == np.array(b.generated))
                     for a, b in zip(done, done_fc)])
    print(f"greedy-token agreement vs exact: {agree:.1%}")


if __name__ == "__main__":
    main()
