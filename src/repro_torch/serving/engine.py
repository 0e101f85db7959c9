"""Batched LLM serving engine: slot-based continuous batching over a
fixed-size decode batch, with optional FastCache decode gating, after the
reference's ``serving/engine.py:ServingEngine``.

The engine owns a KV cache sized (max_batch, window) and a slot table; a
new request is prefilled alone (batch 1) and spliced into a free slot, and
each decode step runs the whole batch.  Finished sequences free their
slots.  With ``greedy=False`` a request's first token (the one drawn from
its prefill's logits) is sampled, as in the reference, through the
``sample_fn(logits, rid) -> int`` hook; the default draws from a
``torch.Generator`` seeded with ``rid`` on the engine's device (the
reference draws ``jax.random.categorical(PRNGKey(rid), logits)``, which
the port cannot reproduce; a parity test hands JAX's draw in).  Decode
steps stay greedy, as the reference's do.

Host syncs: one per admission and one per decode step (the greedy tokens),
counted in ``host_syncs``.  With the FastCache gate on the card, the
decode step is replayed as one CUDA graph (``core/step_graph.py``) on the
engine's fixed (B,) slots, its per-layer skips IF nodes, so the gate reads
nothing on the host; eagerly (the CPU, or ``step_graph=False``) it adds
one read per layer (``decoder.host_syncs``).  The active-slot cache
counters accumulate on the device and are read only by ``cache_stats``
and, with a ``collector``, at ``run``'s end, where they join the
collector's harvest as its device counters.  Every other metric of this engine is a host value the loop
already holds (admissions, tokens, active slots, latencies), so the
metrics plane adds no device work and no sync.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.decode_runner import CachedDecoder
from repro_torch.core.step_graph import StepGraphs
from repro_torch.device import to_device
from repro_torch.models.transformer import TransformerModel
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import MetricsCollector

F64 = torch.float64

SampleFn = Callable[[torch.Tensor, int], int]


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, model: TransformerModel, *, max_batch: int,
                 window: int, eos_id: Optional[int] = None,
                 fastcache: Optional[FastCacheConfig] = None,
                 greedy: bool = True,
                 collector: Optional[MetricsCollector] = None,
                 sample_fn: Optional[SampleFn] = None,
                 step_graph: Optional[bool] = None):
        """``step_graph``: replay the gated decode step as a CUDA graph (the
        card's default with the gate on; the CPU has no graphs)."""
        self.model = model
        self.device = model.device
        on_card = self.device.type == "cuda"
        if step_graph and not on_card:
            raise ValueError("step graphs are CUDA graphs: the model is on "
                             f"{self.device}")
        self.greedy = greedy
        self.sample_fn = None if greedy else (sample_fn or self.sample_token)
        self.collector = collector
        self.max_batch = max_batch
        self.window = window
        self.eos_id = eos_id
        self.cache = model.init_cache(max_batch, window)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_tokens = np.zeros((max_batch,), np.int64)
        self.decoder = None
        if fastcache is not None and fastcache.enabled:
            self.decoder = CachedDecoder(model, fastcache)
            self.fc_state = self.decoder.init_state(max_batch)
            # headline counters accumulate only ACTIVE slots' decisions —
            # idle slots re-feed their stale token, trivially skip every
            # block, and would otherwise inflate the cache ratio
            self.active_blocks_skipped = torch.zeros((), dtype=F64,
                                                     device=self.device)
            self.active_blocks_computed = torch.zeros((), dtype=F64,
                                                      device=self.device)
        self.graphs = (StepGraphs() if self.decoder is not None
                       and (on_card if step_graph is None else step_graph)
                       else None)
        self.host_syncs = 0
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_s = 0.0        # host wall time of admissions (prefills)

    # -- device work ----------------------------------------------------

    def _prefill(self, prompt: np.ndarray, slot: int) -> torch.Tensor:
        """Prefill ONE request (batch 1) and splice its cache into `slot`:
        every leaf (K/V/pos and each mixer's state, (n, B, ...)) along its
        batch axis 1, ``step`` along axis 0."""
        tokens = to_device(np.asarray(prompt, np.int64)[None], self.device)
        logits, one = self.model.prefill({"tokens": tokens}, self.window)
        for key, leaf in one.items():
            if key != "step":
                self.cache[key][:, slot].copy_(leaf[:, 0])
        self.cache["step"][slot].copy_(one["step"][0])
        return logits[0]

    # -- host orchestration --------------------------------------------

    def add_request(self, req: Request) -> bool:
        for s in range(self.max_batch):
            if self.slots[s] is None:
                t0 = time.perf_counter()
                logits = self._prefill(req.prompt, s)
                if self.decoder is not None:
                    # per-slot gating: re-arm only this slot's trackers — the
                    # other slots' caches stay valid across the admission
                    self.decoder.reset_slot(self.fc_state, s)
                if self.greedy:
                    nxt = int(torch.argmax(logits))  # host sync
                else:
                    nxt = int(self.sample_fn(logits, req.rid))
                self.host_syncs += 1
                self.prefill_s += time.perf_counter() - t0
                self.prefills += 1
                req.generated.append(nxt)
                self.slots[s] = req
                self.slot_tokens[s] = nxt
                if self.collector is not None:
                    self.collector.inc(obs_metrics.ADMISSIONS)
                    self.collector.inc(obs_metrics.PREFILLS)
                return True
        return False

    def sample_token(self, logits: torch.Tensor, rid: int) -> int:
        """The default ``sample_fn``: one categorical draw from
        ``softmax(logits)`` with a ``torch.Generator`` seeded by ``rid`` on
        the engine's device (one host read, the admission's)."""
        gen = torch.Generator(self.device).manual_seed(int(rid))
        probs = torch.softmax(logits.float(), dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def step(self) -> None:
        """One batched decode step for all active slots."""
        tokens = to_device(self.slot_tokens, self.device)
        n_active = sum(1 for r in self.slots if r is not None and not r.done)
        if self.decoder is None:
            logits, self.cache = self.model.decode_step(tokens, self.cache)
        else:
            active = to_device(np.array(
                [r is not None and not r.done for r in self.slots]),
                self.device)
            keys = ("blocks_skipped", "blocks_computed")
            # the step writes the counters in place: stack a copy first
            stats = self.fc_state["stats"]
            before = torch.stack([stats[k] for k in keys])
            logits = self._gated_decode(tokens)
            delta = ((torch.stack([stats[k] for k in keys]) - before)
                     * active).sum(dim=1, dtype=F64)
            self.active_blocks_skipped.add_(delta[0])
            self.active_blocks_computed.add_(delta[1])
        if self.collector is not None:
            self.collector.inc(obs_metrics.SERVE_STEPS)
            self.collector.inc(obs_metrics.ACTIVE_SLOT_STEPS, n_active)
            self.collector.inc(obs_metrics.DECODE_TOKENS, n_active)
            self.collector.observe(obs_metrics.ACTIVE_SLOTS, n_active)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()     # host sync
        self.host_syncs += 1
        self.decode_steps += 1
        for s, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            tok = int(nxt[s])
            req.generated.append(tok)
            self.slot_tokens[s] = tok
            if ((self.eos_id is not None and tok == self.eos_id)
                    or len(req.generated) >= req.max_new_tokens):
                req.done = True
                self.slots[s] = None
                if self.collector is not None:
                    self.collector.inc(obs_metrics.REQUESTS_FINISHED)
                    self.collector.observe(obs_metrics.REQUEST_LATENCY,
                                           len(req.generated))

    def _gated_decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """The decode gate's step on every slot, replayed as a graph where
        the engine has them; returns the logits (a graph's buffer)."""
        if self.graphs is None:
            logits, _, _ = self.decoder.decode_step(tokens, self.cache,
                                                    self.fc_state)
            return logits
        cfg = self.model.cfg
        return self.graphs.run(
            ("decode", cfg.name, cfg.num_layers, self.decoder.split_maps,
             tuple(tokens.shape), tokens.dtype, self.window),
            lambda tok: self.decoder.decode_step(tok, self.cache,
                                                 self.fc_state)[0],
            (tokens,), (self.cache, self.fc_state))

    def run(self, requests: List[Request], max_steps: int = 1024
            ) -> List[Request]:
        pending = list(requests)
        finished: List[Request] = []
        active: List[Request] = []
        steps = 0
        while (pending or any(self.slots)) and steps < max_steps:
            while pending and self.add_request(pending[0]):
                active.append(pending.pop(0))
            self.step()
            steps += 1
            for r in active:
                if r.done and r not in finished:
                    finished.append(r)
        if self.collector is not None:
            self.harvest_metrics(at_step=steps)
        return finished + [r for r in active if r not in finished]

    def harvest_metrics(self, at_step: Optional[int] = None
                        ) -> Optional[Dict]:
        """Hand the collector a window: the host counters it holds, and the
        decode gate's active-slot block counters from the device (the one
        device read of the metrics plane, at run end)."""
        if self.collector is None:
            return None
        device = None
        if self.decoder is not None:
            device = {"counters": {
                obs_metrics.BLOCKS_SKIPPED: self.active_blocks_skipped,
                obs_metrics.BLOCKS_COMPUTED: self.active_blocks_computed}}
        return self.collector.harvest(device, at_step=at_step)

    def cache_stats(self) -> Dict:
        """Engine-lifetime cache counters.  The headline numbers count only
        decisions made while a slot had a live request (idle slots skip
        trivially); the raw per-slot (batch,) accumulators — which do
        include idle periods — are reported under per_slot_*."""
        if self.decoder is None:
            return {}
        s = self.fc_state["stats"]
        skipped = float(self.active_blocks_skipped)
        tot = float(self.active_blocks_computed) + skipped
        return {"blocks_skipped": skipped,
                "block_cache_ratio": skipped / tot if tot else 0.0,
                "per_slot_blocks_skipped": [
                    float(v) for v in s["blocks_skipped"].cpu()],
                "per_slot_blocks_computed": [
                    float(v) for v in s["blocks_computed"].cpu()]}
