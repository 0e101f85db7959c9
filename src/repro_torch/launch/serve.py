"""LLM serving launcher for the port: batched prefill + decode with
optional FastCache decode gating, on one CUDA card (the reference's
``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --fastcache --json

``--arch`` takes any registered LLM id (dense, MoE, hybrid, SSM or VLM);
an encoder id (hubert-xlarge) exits with the reference's "encoder-only"
line.
``--num-layers N`` keeps the config's width and cuts its depth to N layers
(0: the config's own; a multiple of the block pattern's period), so that a
full-width MoE (arctic-480b, kimi-k2-1t-a32b: 480 B and 1 T parameters) or
Jamba (52 B; one period of 8 layers is 26.6 GB) fits one card.  The decode
gate needs a period-1 attention stack: ``--fastcache`` on a hybrid or SSM
stack (jamba-v0.1-52b, xlstm-1.3b) prints the reference's line and serves
exact, as the reference's launcher does.

Weights are random (``torch.Generator`` seeded from ``--seed``); prompts
are drawn by ``numpy.random.default_rng(seed)``.  After an untimed warm-up
on a fresh engine, prints decode steps and tokens per second of wall time,
prefill ms per request and, with ``--fastcache``, the block cache ratio.
``--device cpu --reduced`` runs the plain PyTorch path on the reduced model
in f32.

``LLMWorkload`` is the one definition of the served configuration: its
defaults are the flags' defaults, and ``chip_smoke.py`` builds its LLM
serve from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import (ENCODER_IDS, LLM_IDS, get_config,
                                 get_reduced)
from repro_torch.configs.base import FastCacheConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import TransformerModel
from repro_torch.serving.engine import Request, ServingEngine


@dataclass(frozen=True)
class LLMWorkload:
    """An LLM serve: the model, the decode gate, the engine and the
    requests.  ``num_layers`` > 0 cuts the config's depth to that many
    layers at its full width; it adds no feature to the system, only lets a
    config whose full depth does not fit one card run there."""
    arch: str = "qwen3-0.6b"
    reduced: bool = False           # the reduced config, in f32
    num_layers: int = 0             # 0: the config's own depth
    requests: int = 8
    prompt_len: int = 512
    new_tokens: int = 64
    max_batch: int = 4
    window: int = 1024              # KV ring slots, and the prefill's window
    fastcache: bool = False         # the FastCache decode gate
    greedy: bool = True             # False: sample each first token
    seed: int = 0                   # weights and prompts
    # the gated decode step as a CUDA graph: None is the engine's default
    # (on the card), False its eager path
    step_graph: Optional[bool] = None

    def config(self) -> ModelConfig:
        cfg = get_reduced(self.arch) if self.reduced else get_config(self.arch)
        if self.reduced:
            cfg = cfg.replace(dtype="float32")
        if self.num_layers:
            cfg = cfg.replace(num_layers=self.num_layers)
        return cfg

    def build_model(self, device) -> TransformerModel:
        dev = resolve_device(device)
        return build_model(self.config(), device=dev).init(
            torch.Generator(dev).manual_seed(self.seed))

    def build_engine(self, model: TransformerModel) -> ServingEngine:
        return ServingEngine(
            model, max_batch=self.max_batch, window=self.window,
            fastcache=FastCacheConfig() if self.fastcache else None,
            greedy=self.greedy, step_graph=self.step_graph)

    def build_requests(self, model: TransformerModel) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        return [Request(rid=i,
                        prompt=rng.integers(0, model.cfg.vocab_size,
                                            self.prompt_len).astype(np.int32),
                        max_new_tokens=self.new_tokens)
                for i in range(self.requests)]

    def warm_up(self, model: TransformerModel) -> ServingEngine:
        """Serve two short requests on a fresh engine, so that the first
        calls of the math libraries and of the kernel (its build included)
        land here and not in a timed run.  Returns the engine it used."""
        short = dataclasses.replace(self, requests=2,
                                    prompt_len=min(self.prompt_len, 32),
                                    new_tokens=4)
        eng = short.build_engine(model)
        eng.run(short.build_requests(model))
        return eng


GATE_NEEDS_ATTENTION = ("[serve] FastCache decode gating needs a period-1 "
                        "attention stack; running without it")


def exact_fallback(wl: LLMWorkload, model: TransformerModel
                   ) -> Tuple[LLMWorkload, Optional[str]]:
    """The reference launcher's rule: the decode gate (``CachedDecoder``)
    takes only a period-1 attention stack, so ``wl`` with ``fastcache`` on
    any other model comes back exact, with the line to print; else ``wl``
    as it is and None."""
    if wl.fastcache and model.kinds != ("attn",):
        return dataclasses.replace(wl, fastcache=False), GATE_NEEDS_ATTENTION
    return wl, None


def serve(wl: LLMWorkload, model: TransformerModel
          ) -> Tuple[Dict, ServingEngine, List[Request]]:
    """Serve ``wl`` on a fresh engine, timed.  Returns the summary, the
    engine and the finished requests."""
    dev = model.device
    eng = wl.build_engine(model)
    reqs = wl.build_requests(model)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in done)
    decode_s = wall - eng.prefill_s
    syncs = eng.host_syncs + (eng.decoder.host_syncs if eng.decoder else 0)
    out = {
        "arch": model.cfg.name, "num_layers": model.cfg.num_layers,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "fastcache": wl.fastcache, "greedy": wl.greedy,
        "max_batch": wl.max_batch,
        "window": wl.window, "prompt_len": wl.prompt_len,
        "requests": len(reqs), "finished": len(done), "tokens": tokens,
        "decode_steps": eng.decode_steps, "prefills": eng.prefills,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "decode_steps_per_s": eng.decode_steps / decode_s,
        "prefill_ms_per_request": 1e3 * eng.prefill_s / eng.prefills,
        "host_syncs": syncs,
        "host_syncs_per_decode_step": ((syncs - eng.prefills)
                                       / eng.decode_steps),
    }
    stats = eng.cache_stats()
    if stats:
        out["block_cache_ratio"] = stats["block_cache_ratio"]
        out["blocks_skipped"] = stats["blocks_skipped"]
        out["layers_all_skipped_per_decode_step"] = (
            float(eng.fc_state["stats"]["layers_skipped"])
            / eng.decode_steps)
    return out, eng, done


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=LLMWorkload.arch,
                    choices=LLM_IDS + ENCODER_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--num-layers", type=int, default=LLMWorkload.num_layers,
                    help="cut the config's depth to this many layers at its "
                         "full width (0: the config's own)")
    ap.add_argument("--requests", type=int, default=LLMWorkload.requests)
    ap.add_argument("--prompt-len", type=int, default=LLMWorkload.prompt_len)
    ap.add_argument("--new-tokens", type=int, default=LLMWorkload.new_tokens)
    ap.add_argument("--max-batch", type=int, default=LLMWorkload.max_batch)
    ap.add_argument("--window", type=int, default=LLMWorkload.window)
    ap.add_argument("--fastcache", action="store_true")
    ap.add_argument("--sampled", dest="greedy", action="store_false",
                    help="sample each request's first token (seeded by its "
                         "rid) instead of taking the argmax")
    ap.add_argument("--seed", type=int, default=LLMWorkload.seed)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    args = parse_args(argv)
    wl = LLMWorkload(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(LLMWorkload)
                        if hasattr(args, f.name)})
    cfg = wl.config()
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    model = wl.build_model(args.device)
    wl, line = exact_fallback(wl, model)
    if line is not None:
        print(line)
    wl.warm_up(model)
    summary = serve(wl, model)[0]
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k:>28}: {v}")


if __name__ == "__main__":
    main()
